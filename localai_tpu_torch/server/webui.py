"""Embedded WebUI (a copy of localai_tpu/server/webui.py: the same page).

Reference: core/http/views (23 templates: chat, models, model editor,
gallery install, agent jobs, tts, image generation, talk) + ui.go/
ui_api.go routes. Here: one dependency-free single-page app served at `/`
that drives the same public APIs the CLI and SDKs use — chat with SSE
streaming, realtime talk over the /v1/realtime WebSocket (text turns +
mic streaming with server-VAD), model list + load state, a model config
editor (import/edit/delete/reload), gallery browse/install with job
polling, an agent-jobs panel (create/run/toggle/history), TTS playback,
image generation. No build step, no external assets. The talk, tts and
image tabs reach the port's /v1/realtime, /v1/audio/speech and
/v1/images/generations; the port does not serve the p2p routes yet
(ROADMAP Queue A item 12).
"""

from __future__ import annotations

from localai_tpu_torch.server.app import Request, Response, Router


def register_webui(router: Router) -> None:
    def index(req: Request) -> Response:
        """WebUI single-page app."""
        return Response(body=_HTML, content_type="text/html; charset=utf-8")

    router.add("GET", "/", index)
    router.add("GET", "/index.html", index)


_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><meta name="viewport" content="width=device-width,initial-scale=1">
<title>localai-tpu</title><style>
:root{--b:#0a6b5d;--bg:#fafafa;--fg:#1c1c1c;--mut:#777;--line:#e3e3e3}
*{box-sizing:border-box}body{margin:0;font-family:system-ui,sans-serif;background:var(--bg);color:var(--fg)}
header{display:flex;align-items:center;gap:1.5rem;padding:.8rem 1.4rem;background:#fff;border-bottom:1px solid var(--line)}
header h1{font-size:1.05rem;margin:0}
nav button{background:none;border:none;padding:.45rem .8rem;font-size:.95rem;cursor:pointer;border-radius:6px;color:var(--mut)}
nav button.on{background:var(--b);color:#fff}
main{max-width:900px;margin:1.2rem auto;padding:0 1rem}
.card{background:#fff;border:1px solid var(--line);border-radius:8px;padding:1rem;margin-bottom:1rem}
select,input,textarea{font:inherit;padding:.45rem .6rem;border:1px solid var(--line);border-radius:6px;width:100%}
button.act{background:var(--b);color:#fff;border:none;border-radius:6px;padding:.5rem 1rem;font:inherit;cursor:pointer}
button.act:disabled{opacity:.5}
#log{display:flex;flex-direction:column;gap:.6rem;min-height:200px;max-height:55vh;overflow-y:auto;padding:.4rem}
.msg{padding:.55rem .8rem;border-radius:10px;max-width:85%;white-space:pre-wrap}
.msg.user{align-self:flex-end;background:var(--b);color:#fff}
.msg.assistant{align-self:flex-start;background:#efefef}
.row{display:flex;gap:.6rem;margin-top:.6rem}
table{width:100%;border-collapse:collapse}td,th{text-align:left;padding:.45rem;border-bottom:1px solid var(--line)}
.pill{font-size:.75rem;padding:.1rem .5rem;border-radius:999px;background:#eee;color:var(--mut)}
.pill.loaded{background:#d9f2ea;color:var(--b)}
#imgout img{max-width:256px;border-radius:8px;margin:.3rem}
.small{font-size:.8rem;color:var(--mut)}
</style></head><body>
<header><h1>localai-tpu</h1><nav id="nav"></nav>
<span style="flex:1"></span><a class="small" href="/swagger">API docs</a></header>
<main id="main"></main>
<script>
const TABS={chat:Chat,talk:Talk,models:Models,editor:Editor,gallery:GalleryTab,jobs:Jobs,tts:TTS,image:Images};
let tab='chat';
function nav(){const n=document.getElementById('nav');n.innerHTML='';
 for(const t of Object.keys(TABS)){const b=document.createElement('button');
  b.textContent=t;b.className=t===tab?'on':'';b.onclick=()=>{tab=t;render()};n.appendChild(b)}}
function render(){nav();document.getElementById('main').innerHTML='';TABS[tab](document.getElementById('main'))}
async function models(uc){const r=await fetch('/v1/models');const d=await r.json();return d.data.map(m=>m.id)}
// All server-sourced strings (model names, gallery entries, job fields) go
// through esc() before any innerHTML interpolation — they are API-writable.
function esc(s){return String(s==null?'':s).replace(/[&<>"']/g,c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]))}
function sel(opts,id){return `<select id="${id}">`+opts.map(o=>`<option>${esc(o)}</option>`).join('')+`</select>`}

function Chat(el){
 el.innerHTML=`<div class="card"><div class="row"><div style="flex:1" id="mslot"></div></div>
 <div id="log"></div><div class="row"><textarea id="inp" rows="2" placeholder="Say something…"></textarea>
 <button class="act" id="send">Send</button></div></div>`;
 models().then(ms=>{document.getElementById('mslot').innerHTML=sel(ms,'model')});
 const hist=[];
 document.getElementById('send').onclick=async()=>{
  const inp=document.getElementById('inp');const text=inp.value.trim();if(!text)return;
  inp.value='';hist.push({role:'user',content:text});
  const log=document.getElementById('log');
  log.insertAdjacentHTML('beforeend',`<div class="msg user"></div>`);
  log.lastChild.textContent=text;
  log.insertAdjacentHTML('beforeend',`<div class="msg assistant"></div>`);
  const out=log.lastChild;log.scrollTop=log.scrollHeight;
  const resp=await fetch('/v1/chat/completions',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify({model:document.getElementById('model').value,messages:hist,stream:true})});
  const rd=resp.body.getReader();const dec=new TextDecoder();let buf='',acc='';
  for(;;){const{done,value}=await rd.read();if(done)break;buf+=dec.decode(value,{stream:true});
   let i;while((i=buf.indexOf('\n\n'))>=0){const f=buf.slice(0,i);buf=buf.slice(i+2);
    const line=f.split('\n').find(l=>l.startsWith('data: '));if(!line)continue;
    const data=line.slice(6);if(data==='[DONE]')continue;
    try{const c=JSON.parse(data);const d=c.choices&&c.choices[0].delta;
     if(d&&d.content){acc+=d.content;out.textContent=acc;log.scrollTop=log.scrollHeight}}catch(e){}}}
  hist.push({role:'assistant',content:acc});};
}

async function Models(el){
 el.innerHTML=`<div class="card"><table id="mt"><tr><th>model</th><th>backend</th><th>state</th><th></th></tr></table></div>`;
 const sys=await(await fetch('/system')).json();
 const loaded=new Set(sys.loaded_models||[]);
 const list=await(await fetch('/v1/models')).json();
 const t=document.getElementById('mt');
 for(const m of list.data){const tr=document.createElement('tr');
  tr.innerHTML=`<td>${esc(m.id)}</td><td class="small">${esc(m.owned_by)}</td>
  <td><span class="pill ${loaded.has(m.id)?'loaded':''}">${loaded.has(m.id)?'loaded':'idle'}</span></td>
  <td>${loaded.has(m.id)?`<button class="act" data-m="${esc(m.id)}">unload</button>`:''}</td>`;
  t.appendChild(tr)}
 t.onclick=async e=>{const m=e.target.dataset&&e.target.dataset.m;if(!m)return;
  await fetch('/backend/shutdown',{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify({model:m})});
  Models(el)};
}

async function GalleryTab(el){
 el.innerHTML=`<div class="card" id="gl">loading gallery…</div>`;
 const g=document.getElementById('gl');
 try{
  const d=await(await fetch('/models/available')).json();
  if(!d.length){g.textContent='no galleries configured';return}
  g.innerHTML=`<table>`+d.map(m=>`<tr><td>${esc(m.name)}</td><td class="small">${esc(m.description||'')}</td>
   <td><button class="act" data-n="${esc(m.gallery?m.gallery+'@':'')}${esc(m.name)}">install</button></td></tr>`).join('')+`</table><div id="job"></div>`;
  g.onclick=async e=>{const n=e.target.dataset&&e.target.dataset.n;if(!n)return;
   const r=await(await fetch('/models/apply',{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify({id:n})})).json();
   const poll=async()=>{const s=await(await fetch('/models/jobs/'+r.uuid)).json();
    document.getElementById('job').textContent=`${n}: ${s.message||''} ${s.processed?'done':''}`;
    if(!s.processed)setTimeout(poll,500)};poll()};
 }catch(e){g.textContent='gallery unavailable: '+e}
}

function TTS(el){
 el.innerHTML=`<div class="card"><div id="ts"></div>
 <div class="row"><input id="txt" placeholder="Text to speak"><button class="act" id="go">Speak</button></div>
 <div class="row"><audio id="au" controls style="width:100%"></audio></div></div>`;
 models().then(ms=>{document.getElementById('ts').innerHTML=sel(ms,'tmodel')});
 document.getElementById('go').onclick=async()=>{
  const r=await fetch('/v1/audio/speech',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify({model:document.getElementById('tmodel').value,input:document.getElementById('txt').value})});
  if(!r.ok){alert('tts failed: '+(await r.text()));return}
  document.getElementById('au').src=URL.createObjectURL(await r.blob())};
}

async function Editor(el){
 // Model config editor (reference: views/model-editor.html): pick a config,
 // edit the persisted dict as JSON, save via /models/edit, create new via
 // /models/import, delete, hot-reload all configs.
 el.innerHTML=`<div class="card"><div class="row"><div style="flex:1" id="es"></div>
 <button class="act" id="new">New</button><button class="act" id="reload">Reload configs</button></div>
 <textarea id="cfg" rows="16" spellcheck="false" style="font-family:monospace;margin-top:.6rem"></textarea>
 <div class="row"><button class="act" id="save">Save</button>
 <button class="act" id="del" style="background:#a33">Delete</button>
 <span class="small" id="emsg"></span></div></div>`;
 const msg=t=>{document.getElementById('emsg').textContent=t};
 async function pick(name){
  const r=await fetch('/models/config/'+encodeURIComponent(name));
  if(!r.ok){msg('load failed: '+await r.text());return}
  document.getElementById('cfg').value=JSON.stringify(await r.json(),null,2)}
 async function refresh(){
  const ms=await models();
  document.getElementById('es').innerHTML=sel(ms,'emodel');
  document.getElementById('emodel').onchange=e=>pick(e.target.value);
  if(ms.length)pick(ms[0])}
 refresh();
 document.getElementById('new').onclick=()=>{
  document.getElementById('cfg').value=JSON.stringify({name:'my-model',model:'',backend:'llama'},null,2)};
 document.getElementById('save').onclick=async()=>{
  let d;try{d=JSON.parse(document.getElementById('cfg').value)}catch(e){msg('invalid JSON: '+e);return}
  const exists=(await models()).includes(d.name);
  const r=exists?await fetch('/models/edit/'+encodeURIComponent(d.name),{method:'POST',
    headers:{'Content-Type':'application/json'},body:JSON.stringify(d)})
   :await fetch('/models/import',{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(d)});
  msg(r.ok?'saved':'save failed: '+await r.text());if(r.ok)refresh()};
 document.getElementById('del').onclick=async()=>{
  const n=document.getElementById('emodel').value;if(!n)return;
  const r=await fetch('/models/delete/'+encodeURIComponent(n),{method:'POST'});
  msg(r.ok?'deleted '+n:'delete failed: '+await r.text());refresh()};
 document.getElementById('reload').onclick=async()=>{
  const r=await fetch('/models/reload',{method:'POST'});
  msg(r.ok?'reloaded':'reload failed')};
}

async function Jobs(el){
 // Agent jobs panel (reference: views/agent-jobs.html): list, create with a
 // cron schedule, run now, enable/disable, delete, view run history.
 el.innerHTML=`<div class="card"><table id="jt"><tr><th>name</th><th>model</th><th>schedule</th><th>enabled</th><th></th></tr></table>
 <div class="row"><input id="jn" placeholder="name"><input id="jm" placeholder="model">
 <input id="js" placeholder="schedule e.g. */5 * * * *"></div>
 <div class="row"><textarea id="jp" rows="2" placeholder="prompt"></textarea>
 <button class="act" id="jc">Create</button></div>
 <pre class="small" id="jh"></pre></div>`;
 async function refresh(){
  const t=document.getElementById('jt');
  const r=await fetch('/agent-jobs');
  if(!r.ok){t.innerHTML='<tr><td class="small">agent jobs unavailable (no MCP/agent service)</td></tr>';return}
  const jobs=(await r.json()).jobs||[];
  t.innerHTML='<tr><th>name</th><th>model</th><th>schedule</th><th>enabled</th><th></th></tr>';
  for(const j of jobs){const tr=document.createElement('tr');const id=esc(j.id);
   tr.innerHTML=`<td>${esc(j.name)}</td><td class="small">${esc(j.model)}</td><td class="small">${esc(j.schedule||'')}</td>
   <td><button class="act" data-a="toggle" data-id="${id}" data-en="${j.enabled}">${j.enabled?'on':'off'}</button></td>
   <td><button class="act" data-a="run" data-id="${id}">run</button>
   <button class="act" data-a="hist" data-id="${id}">history</button>
   <button class="act" data-a="del" data-id="${id}" style="background:#a33">x</button></td>`;
   t.appendChild(tr)}
  t.onclick=async e=>{const a=e.target.dataset&&e.target.dataset.a;if(!a)return;
   const id=e.target.dataset.id;
   if(a==='run')await fetch('/agent-jobs/'+id+'/run',{method:'POST'});
   if(a==='del')await fetch('/agent-jobs/'+id,{method:'DELETE'});
   if(a==='toggle')await fetch('/agent-jobs/'+id,{method:'PUT',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({enabled:e.target.dataset.en!=='true'})});
   if(a==='hist'){const h=await(await fetch('/agent-jobs/'+id+'/history')).json();
    document.getElementById('jh').textContent=JSON.stringify(h,null,2);return}
   refresh()};
 }
 refresh();
 document.getElementById('jc').onclick=async()=>{
  const r=await fetch('/agent-jobs',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify({name:document.getElementById('jn').value,model:document.getElementById('jm').value,
    prompt:document.getElementById('jp').value,schedule:document.getElementById('js').value})});
  if(!r.ok)alert('create failed: '+await r.text());refresh()};
}

function Talk(el){
 // Realtime talk page (reference: views/talk.html) against the existing
 // WS /v1/realtime: text turns always work; the mic button streams pcm16
 // with server-VAD turn detection; response audio deltas play back.
 el.innerHTML=`<div class="card"><div class="row"><div style="flex:1" id="tsl"></div>
 <button class="act" id="conn">Connect</button><button class="act" id="mic" disabled>Mic</button></div>
 <div id="log"></div>
 <div class="row"><textarea id="tinp" rows="2" placeholder="Type a turn…"></textarea>
 <button class="act" id="tsend" disabled>Send</button></div>
 <div class="small" id="tst">disconnected</div></div>`;
 models().then(ms=>{document.getElementById('tsl').innerHTML=sel(ms,'tkmodel')});
 let ws=null,ac=null,micNode=null,micStream=null,playT=0,out=null;
 function micOff(){if(micNode){micNode.disconnect();micNode=null}
  if(micStream){micStream.getTracks().forEach(t=>t.stop());micStream=null}
  const b=document.getElementById('mic');if(b)b.textContent='Mic'}
 const st=t=>{document.getElementById('tst').textContent=t};
 const log=document.getElementById('log');
 function playPcm(b64){
  if(!ac)ac=new AudioContext({sampleRate:24000});
  const raw=atob(b64);const n=raw.length/2;const f=new Float32Array(n);
  for(let i=0;i<n;i++){let v=(raw.charCodeAt(2*i)|(raw.charCodeAt(2*i+1)<<8));if(v>=32768)v-=65536;f[i]=v/32768}
  const buf=ac.createBuffer(1,n,24000);buf.copyToChannel(f,0);
  const src=ac.createBufferSource();src.buffer=buf;src.connect(ac.destination);
  playT=Math.max(playT,ac.currentTime);src.start(playT);playT+=n/24000}
 document.getElementById('conn').onclick=()=>{
  if(ws){ws.close();return}
  const m=document.getElementById('tkmodel').value;
  ws=new WebSocket((location.protocol==='https:'?'wss://':'ws://')+location.host+'/v1/realtime?model='+encodeURIComponent(m));
  ws.onopen=()=>{st('connected');document.getElementById('tsend').disabled=false;
   document.getElementById('mic').disabled=false;
   ws.send(JSON.stringify({type:'session.update',session:{turn_detection:{type:'server_vad',silence_duration_ms:500}}}))};
  ws.onclose=()=>{st('disconnected');ws=null;micOff();
   document.getElementById('tsend').disabled=true;
   document.getElementById('mic').disabled=true};
  ws.onmessage=e=>{const ev=JSON.parse(e.data);
   if(ev.type==='conversation.item.created'&&ev.item.role==='user'){
    const c=ev.item.content[0];const txt=c.transcript!==undefined?c.transcript:c.text;
    log.insertAdjacentHTML('beforeend','<div class="msg user"></div>');log.lastChild.textContent=txt}
   if(ev.type==='response.created'){log.insertAdjacentHTML('beforeend','<div class="msg assistant"></div>');
    out=log.lastChild}
   if((ev.type==='response.text.delta'||ev.type==='response.audio_transcript.delta')&&out){
    out.textContent+=ev.delta;log.scrollTop=log.scrollHeight}
   if(ev.type==='response.audio.delta')playPcm(ev.delta);
   if(ev.type==='error')st('error: '+ev.error.message)}};
 document.getElementById('tsend').onclick=()=>{
  const t=document.getElementById('tinp').value.trim();if(!t||!ws)return;
  document.getElementById('tinp').value='';
  ws.send(JSON.stringify({type:'conversation.item.create',item:{type:'message',role:'user',
   content:[{type:'input_text',text:t}]}}));
  ws.send(JSON.stringify({type:'response.create'}))};
 document.getElementById('mic').onclick=async()=>{
  if(micNode){micOff();return}
  micStream=await navigator.mediaDevices.getUserMedia({audio:true});
  if(!ac)ac=new AudioContext({sampleRate:24000});
  const src=ac.createMediaStreamSource(micStream);
  micNode=ac.createScriptProcessor(4096,1,1);
  micNode.onaudioprocess=e=>{if(!ws)return;
   const f=e.inputBuffer.getChannelData(0);const b=new Int16Array(f.length);
   for(let i=0;i<f.length;i++)b[i]=Math.max(-32768,Math.min(32767,f[i]*32768));
   const u8=new Uint8Array(b.buffer);let s='';for(let i=0;i<u8.length;i++)s+=String.fromCharCode(u8[i]);
   ws.send(JSON.stringify({type:'input_audio_buffer.append',audio:btoa(s)}))};
  src.connect(micNode);micNode.connect(ac.destination);
  document.getElementById('mic').textContent='Stop'};
}

function Images(el){
 el.innerHTML=`<div class="card"><div id="is"></div>
 <div class="row"><input id="prompt" placeholder="Prompt"><button class="act" id="gen">Generate</button></div>
 <div id="imgout"></div></div>`;
 models().then(ms=>{document.getElementById('is').innerHTML=sel(ms,'imodel')});
 document.getElementById('gen').onclick=async()=>{
  const r=await fetch('/v1/images/generations',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify({model:document.getElementById('imodel').value,prompt:document.getElementById('prompt').value,response_format:'b64_json'})});
  if(!r.ok){alert('generation failed: '+(await r.text()));return}
  const d=await r.json();
  document.getElementById('imgout').innerHTML=d.data.map(x=>`<img src="data:image/png;base64,${x.b64_json}">`).join('')};
}
render();
</script></body></html>"""
