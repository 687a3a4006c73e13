"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device  — the card's name, count and power limit; which optional
   packages this machine has (for planning later slices);
2. build   — nvcc builds every kernel library from localai_tpu_torch/csrc
   (one process per source, all at once) and prints what ptxas reports
   (registers and spills of every kernel); a spill in B2's, B3's, B4's or
   B5's tensor-core instances fails the run;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with CUDA-event times of the kernel, the
   plain version, one PyTorch library call computing the same function
   (where one exists), and the least time the card could take (bound):
   B1 flash prefill at the admission shapes (ragged lengths, every row at
   full length, and S = 200; every output bit-identical when launched
   again and for each batch row alone), B2 ragged paged attention at
   the paged decode and chunked-prefill shapes, on fp8 pools with a
   per-head kv_scale, at G = 7, on pages of 16 and 48 rows with limits at
   split edges, and for a 4-token verify (every output bit-identical when
   launched again and for each slot alone); then B2's long-context forms,
   a hierarchical table (table pages of 128) under the sink 128 + window
   4096 skip, at llama-3.2-1b's decode shape for contexts up to 131072, a
   512-token chunk at offset 65536 and one slot at a 1,048,576-token
   limit whose pool holds only the pages it visits: hierarchical equal to
   flat and a spilled table (skipped columns at SCRATCH) equal to the hot
   one bit for bit, timed beside the same slots walked in full; B3 dequant-matmul at llama-3-8b's projection shapes
   (flat int8, grouped int8, packed int4; bf16 and f32 x; 1, 8, 16, 64 and
   256 rows; every output bit-identical when launched again, and up to 16
   rows for each row alone) and B4 int8 unembed at llama-3-8b's head and a
   ragged one (bf16 and f32 h; 1, 8, 16, 64 and 256 rows; bit-identical
   when launched again, and up to 16 bf16 rows for each row alone), with
   the time of a bf16 matmul on the dequantized weight beside them, and
   for B3 the time of the dequantize-then-matmul route at the same rows;
4. model   — a small f32 model on the card against the same model on the
   CPU (logits, 16 greedy decode steps), dense and paged (chunked prefill
   into pages, paged decode), then full-width llama-3.2-1b in bf16 with
   seeded random weights, cut to 4 of its 16 layers (as every 1b phase):
   prefill logits through the kernel against the same call through plain
   attention;
5. engine  — the dense serving engine (submit → fused admission → decode
   blocks → streamed events) answers mixed requests on llama-3.2-1b
   (4 layers);
6. paged engine — the same model on a paged KV pool with chunked prefill
   (long prompts chunk, decode blocks run between chunks), then the small
   f32 model's paged engine against its dense engine;
7. quantized model — llama-3-8b at full width and depth, seeded random
   bf16 weights quantized on the card to int8 and to int4: prefill at 256
   rows (the kernels' route) and 1024 rows (the dequantize-then-matmul
   route) and 16 greedy decode steps, against the same weights through the
   dequantize-then-matmul route everywhere;
8. quantized engines — llama-3-8b (its first 16 of 32 layers, cut for
   time) int8 on a paged bf16 pool, then int4 on an fp8 (e4m3) pool with
   kv_scale 2, with phase 6's mix of prompts; then
   the small f32 model's int4 + fp8 paged engine on the card against the
   same engine on the CPU;
9. lora kernels — B5 (the ragged LoRA delta) against its plain version at
   every target projection shape of llama-3.2-1b and llama-3-8b, rank 16
   and 64, 8 adapters and a null row, 1 and 256 rows, mixed ranks, and as
   one launch per group of targets that share x at the served groups
   (1b q / k / v and gate / up at rank 32, 8b q / v at rank 16): null
   rows exact zeros, every row bit-identical to a launch on it alone, two
   launches bit-identical, nothing allocated but the outputs;
10. lora http — llama-3.2-1b (4 of 16 layers, bf16) served by the port's own
   HTTP server with 8 virtual-model tenants (PEFT adapters from a seed):
   a warm pass, then 12 concurrent chat / completion requests (half
   streamed, half greedy) to the tenants and the base, checked over HTTP
   (B5 launches = decode steps x layers x 4 groups);
   then the same 12 to a base with no tenants (the tenancy cost);
11. lora 8b int8 — llama-3-8b int8 (its first 16 of 32 layers) with 4 tenants and 4 adapter-less
   requests through Engine.submit (B1, B2, B3, B4 and B5 on one path);
   then the small f32 model's paged engine with three tenants and a null
   row on the card against the same engine on the CPU;
12. graphs — the decode block as one CUDA graph per shape: the paged
   engine of phase 6 (llama-3.2-1b, 4 layers; run right after phase 6)
   and of phase 8 (llama-3-8b int4 + fp8, its first 16 of 32 layers;
   right after phase 8) each serve phase 6's requests twice on fresh engines, after
   warmup(): once replaying the graphs warmup captured, once with the
   engine's graph step swapped for its eager block body. Ids (greedy and
   seeded) and kernel launch counts must be identical; the phase prints
   the graphs captured, the capture seconds, the graph pool's bytes and
   both runs' decode tok/s and host ms per step.
13. moe kernels — B3's expert form (every expert of a mixture-of-experts
   projection in one launch) against its plain version at mixtral-8x7b's
   shapes: gate / up [8, 4096, 14336] with x shared by the experts, down
   [8, 14336, 4096] with one x row per expert; flat int8, grouped int8
   and int4; bf16 and f32 x; 1, 8, 16, 64 and 256 rows; bit-identical when
   launched again and, up to 16 rows, for each row alone; times beside a
   bf16 torch.bmm on the dequantized stack and the dequantize-then-matmul
   route;
14. mixtral — mixtral-8x7b at full width, 8 of its 32 layers (cut for
   time: 16 when the deepseek phases joined the run, 8 since phase 23
   did), seeded
   random weights made int4 on the card layer by layer (bf16 would not
   fit at full depth): a 256-row prefill through the kernels, each of its MoE layers
   held to the dequantize-then-matmul route on the same input (within 5 %
   of the layer's largest output; the two free-running prefills' logits
   and the share of tokens whose top-2 experts differ, layer by layer,
   are printed: routing is discrete, so bf16 rounding flips some tokens'
   experts and the runs part), then phase 12's graph-against-eager run on
   a paged bf16 pool with phase 6's requests (B3 = 7 x 8 = 56 launches a decode step,
   24 of them the expert form; B4 one a step; B2 8 a step), the device
   time of one decode step (a graph replay) against the weights' byte
   floor, two admissions' times, the weight bytes and the peak memory;
15. mixtral int8 — the same model in int8 at full width, 8 of its 32
   layers (cut for time), through the paged engine: the flat form;
16. moe small — a small f32 mixtral-family model's paged engine on the
   card against the same engine on the CPU, unquantized (the exact top-k
   route) and int4 (the expert form's f32 kernel);
17. long context (run right after phase 12's 1b pair) — llama-3.2-1b at
   full width, 4 of its 16 layers (bf16), serves one 130,000-token prompt
   and 32 greedy tokens through Engine.submit, after warmup(), on the
   reference ladder's long-context engine (pages of 128, chunks of 512,
   sink 128, window 4096): first with flat tables and every page hot,
   then with table pages of 128 entries and a 2 GiB cold-page spill
   budget. The ids must be identical and pages must spill within the
   budget; the phase prints the device ms of each prefill chunk along the
   prompt, the TTFT, decode tok/s, peak memory and the pages spilled.
18. prefix_swap (run right after 17) — the prefix cache and the host swap
   tier on llama-3.2-1b at full width, 4 of its 16 layers (bf16): (a) 8
   chat conversations sharing a 1536-token system prompt, 3 turns of 64
   tokens each carrying the earlier turns and answers, beside 4 short
   misses, on the paged engine after warmup(), with the default prefix
   knobs and again with prefix_cache_entries=0: hits, matched tokens,
   TTFT of hits and misses, decode tok/s, peak memory, no graph captured
   while serving; ids held to the miss run's (they may part only where a
   plain prefill of the same sequence picks the hit's token or a change
   within 2^-5 of its largest |logit| would), first-token logits within
   that bound; (b) 8 requests on an 88-page pool that must swap (auto)
   against a 256-page pool, ids held the same way; (c) a 16,384-token
   prompt on the hierarchical + spill engine, then an extension: the save
   restores the spilled pages, the entry pins table pages, the extension
   hits with a fresh engine's ids; (d) the small f32 model on the card: hit
   equals miss, swap equals unpressured. Then, right after phase 12's 8b
   pair, prefix_swap_8b: llama-3-8b int4 (its first 16 of 32 layers) on an fp8 pool with kv_scale 2,
   one 1024-token hit against a miss (B2's fp8 walk over the shared pages,
   B3, B4).
19. grammar (run right after 18) — grammar-constrained decoding on
   llama-3.2-1b at full width, 4 of its 16 layers (bf16), with the
   synthetic byte tokenizer on phase 18's paged engine (prefix cache off,
   so a round and its unconstrained batch admit alike): ops/grammar's mask
   and advance on the card bit-equal to the CPU for an [8, 128256] batch in
   "fast" and "walk" mode; the two schemas' table builds and copies to the
   card; warmup(grammar=True) after prewarming both; round A (4 requests on
   a fast schema, 2 greedy and 2 seeded, beside 4 unconstrained), round B
   (the same prompts on the ~678-state tool schema: walk mode), round C (2
   on schemas never prewarmed: the host candidate walk, beside 2
   unconstrained), each beside the same batch unconstrained (decode tok/s
   of each). Every constrained text is a legal prefix (a whole value when
   it stopped); after every block of A and B each DFA slot's device state
   equals a numpy walk of its ids; A and B capture no graph; the
   unconstrained ids equal their runs without constrained neighbours, or
   part at a near tie (as in 18) or, in C, where the same batch alone in
   one-step blocks (the schedule a host-walk slot imposes) parts alike. Then the port's server: a required tool
   call whole and streamed, a json_schema reply and a GBNF completion.
20. tree (run right after 19) — tree sampling, logprobs, deadlines and
   dense chunking on llama-3.2-1b at full width, 4 of its 16 layers (
   bf16, the synthetic byte tokenizer): (a) 4 prompts of 200-1200 tokens,
   each an n = 4 group of seeded top-p requests, through Engine.submit_fork
   on phase 6's paged engine (prefix cache on) after warmup(logprobs=True),
   then the same 16 requests as clones on a fresh engine: 12 branches
   forked, none cloned, no write through a page another slot shares, every
   page back; each branch's bytes equal its clone's or part at a near tie
   (as in 18); group TTFT against the clones'; (b) best_of 8 on a
   1024-token prompt on pages of 64 rows: peak pages <= 1.5 x one
   request's; (c) 8 logprob requests (top 5) beside 8 plain ones: their
   ids equal the same requests' without logprobs or part at a near tie,
   every logprob within 2 x 2^-5 of the position's largest |logit| of a
   teacher-forced plain forward, top-5 ids equal but at near ties; the
   device ms a step of a 16-step logprob block's graph against a plain
   one; (d) 8 busy slots: 4 requests shed by queue_timeout_s 0.5 with the
   reference's error, an active deadline_s ends its slot, cancel_all ends
   the rest, every page back; (e) a 3500-token prompt in 512-token chunks
   over a dense cache against its single-shot admission (ids equal or a
   near tie); the small f32 model: fork = clone and dense chunked = single
   shot, exactly; (f) the port's server: chat logprobs whole and streamed,
   completions logprobs, n 2 of best_of 4 (forked), /v1/tokenize,
   /v1/edits, a body deadline_s on the saturated model (an error naming
   deadline_s) and a model YAML naming a draft model (llama-3.2-1b: the
   reply served through speculative rounds).
21. gguf (run last) — GGUF checkpoints: a spec-derived writer here packs
   two files with random block payloads (scales sized for a weight spread
   of 0.02) and the published shapes and layouts of tensor types:
   llama-3.2-1b as a Q4_K_M file, 4 of its 16 layers (q4_K, attn_v and
   ffn_down q6_K in alternate layers, q6_K embeddings, tied) and llama-3-8b as a
   Q8_0 file with an untied q8_0 output.weight, 2 of its 32 layers (cut
   for time), both with llama-3's gpt2-type BPE metadata (128256 tokens:
   256 byte symbols, synthetic merges, 256 control tokens; llama-bpe
   pre-tokenizer; bos / eos; chat template). Each is parsed and repacked
   (timed; the HTTP load reuses the parse); B3 on every projection of layer 0 in the loader's forms (g4
   with per-group zero points, gq) against its plain version (bf16 x) and
   the dequantize-then-matmul route (f32 x), B4 on the 8b head likewise;
   the synthesized tokenizer runs the native BPE engine, equal to the HF
   tokenizer on the canaries, a chat prompt and 20,000 characters (µs a
   character of each). The 1b file is served by the port's HTTP server
   from a YAML `model: <file>.gguf` (8 concurrent chats, half streamed,
   half greedy, 64 tokens; B3 in both forms, B1, B2); then each file's
   engine against an engine on its dequantized dense bf16 tree (greedy ids
   equal up to a near tie; the 8b run carries B4). Prints the file bytes,
   the parse-and-repack seconds, the device bytes a weight of each form,
   TTFT p50 and decode tok/s.
22. deepseek (run after 16, before 21) — the DeepSeek family and B2's
   latent form. (a) latent_kernels: the paged kernel's latent form (one kv
   head, D = 576, the pool passed as K and V) against its plain version at
   deepseek-v2-lite's decode (8 slots, 16 heads, pages of 128, limits 1
   to 4096, several at split edges), a 6-token verify (QR = 96), a
   512-token chunk at offset 1024 (QR = 8192), bf16 and e4m3 pools at
   kv_scale 2, a hierarchical table under sink 128 + window 4096 at a
   16384-row limit, and tiny-mla's f32 form at D = 48: tol 2e-4,
   bit-identical relaunched and slot by slot, ms, plain ms and bound.
   (b) deepseek: deepseek-v2-lite bf16 at full width, 14 of its 27
   layers (cut for time since phase 23 joined; seeded random weights drawn
   on the card): one 3000-token
   prompt's dense full-rank prefill against its absorbed paged chunks
   (the same choice up to a near tie); phase 6's mix on the paged config
   after warmup(), graphs against the eager body (ids and launches equal,
   B2's latent form 14 launches a decode step), then a follow-up sharing
   request 5's first 1536 tokens (a prefix hit whose tail chunk walks the
   shared latent pages); the dense engine on the same traffic (ids equal
   or parting at a near tie); TTFT, tok/s, a step's device ms from a
   graph replay, B2's share, weight and latent bytes, peak memory, and
   the every-expert route's bytes a step beside the active experts'.
   (c) deepseek_http: a YAML naming deepseek-v2-lite at 14 of its 27
   layers answers 4 concurrent chats, half streamed (200s, [DONE]). (d) deepseek_int4:
   int4 at 8 of 27 layers through the paged engine (B3, its expert form
   at E = 64, B4, B2's latent form by their launch identities). (e)
   deepseek_small: tiny-mla f32, dense, paged and prompt_lookup engines,
   card ids equal to CPU ids. Phase 13 (moe_kernels) also holds B3's
   expert form at deepseek-v2-lite's expert shapes (E = 64, int8 / int4,
   1-256 rows).
23. observe (run after 20) — the runtime, observability and fault layer
   on llama-3.2-1b at full width, 4 of its 16 layers (bf16), on the paged
   config, served by ModelManager and the port's HTTP server with the
   journal on (4096 events), trace_fence, a postmortem directory and a
   profile directory: (a) 8 concurrent chats, 4 with a client W3C
   traceparent: /debug/trace of each response id has the client's trace
   id, spans tiling submit -> terminal, and an admission -> first token
   span within 5 ms of the response's timing_prompt_processing; B1 and B2
   by their launch identities; (b) /debug/timeline parses as Chrome trace
   JSON, every decode block's window carries a fenced device ms in (0, the
   window's wall] and every window's phase vector sums to at most its
   wall; (c) /debug/profile {"seconds": 2} during 8 streaming chats (a
   second window meanwhile gets 409): the exported trace holds B2's
   launches from graph replays and B1's from admissions inside the window,
   and the first chats' logprob blocks capture a graph inside it; (d) the
   journal's cost: 8-slot rounds of 96 tokens as graph replays, journal on
   and off, five each interleaved (gate: on <= 2 x off + 50 ms); (e)
   faults on the served weights (a swapping pool of 40 pages, prefix cache
   off): device_dispatch and control_commit on a block shape not yet
   captured and on a replay, then three seeds of a FaultSchedule over
   device_dispatch, control_commit, page_alloc and host_swap with 16
   requests each: every request ends within OBSERVE_DEADLINE_S, the pool
   is accounted at quiesce, one fault_<site> journal event per injected
   fault; (f) engine_loop faults kill the loop three times under
   restart_budget 2 (the dying requests mid-admission, chunking 3000-token
   prompts): two transparent restarts, then a 503 with Retry-After
   until the quarantine expires; each death's postmortem names its dead
   requests and the loop_dead gauge carries its path before the reap;
   allocated memory after the third restart within 5 % of the first's; a
   fourth death with no traffic is reaped by the watchdog. Prints one
   {"observe": ...} line.
24. embed_rerank (run after 23) — embeddings, rerank, the bert backend and
   the vector store through ModelManager and the port's HTTP server
   (OpenAIApi, RerankApi, StoresApi): (a) llama-3.2-1b bf16 at full width,
   4 of its 16 layers on the paged config with the byte tokenizer:
   /v1/embeddings of 16 inputs of 20-500 tokens (strings and token
   arrays; norms within 1e-3 of 1) and /v1/rerank of 8 documents, one the
   model's own greedy continuation of the query (among printable ASCII
   ids, so its text encodes back to them), which must rank first; each
   twice (B1 = 4 x 16 launches exactly); the same embeddings again while
   8 streamed chats decode (bit-identical, and overlapping the chats); a
   32-document rerank at bucket 2048 with its peak memory against the
   reference's unchunked logits; then f32 witnesses of the same weights on
   the card (each vector's cosine >= 0.999, rerank scores within 2e-2);
   (b) tiny-d64 f32, plain and int8, `encode` and `sequence_logprob` on
   the card (B1's, B3's and B4's f32 kernels) against the CPU within
   1e-4; (c) bge-large (BAAI/bge-large-en-v1.5's widths: 1024, 24 layers,
   16 heads) from a random checkpoint the port's save_hf_bert writes,
   32 inputs embedded over HTTP, the 4 shortest held to the CPU within
   1e-4; (d) a cross-encoder at cross-encoder/ms-marco-MiniLM-L-6-v2's
   widths (384, 6 layers, 12 heads, one label) reranking 16 documents
   over HTTP, held to the CPU within 1e-4; (e) a store of 100,000 x 384
   f32 keys on the card: 100 finds at k = 10 give numpy's indices
   (similarities within 1e-5), ms a find; /stores/* over HTTP.
25. vision (run after 24) — vision chat through ModelManager and the
   port's HTTP server: (a) Qwen2-VL-2B-Instruct at full width and depth
   in bf16 (the published config.json's widths: decoder 1536 / 28 layers /
   12 heads / 2 kv heads / head dim 128 / m-rope sections 16, 24, 24;
   tower depth 32, 1280 wide, 16 heads, patch 14, merge 2), `backend:
   vlm`, from a checkpoint in the published layout written from a seed,
   on a paged pool (pages of 128, chunks of 512) with graph decode blocks:
   the tower at a 448 x 448 image (1024 patches, 256 merged tokens) and at
   the processor's largest pixel budget (1120 x 896: 5120 patches, 1280
   tokens) with its time and peak memory; the bf16 tower against the same
   tower in f32 on the card (cosine of the merged tokens >= 0.99); prefill
   with the image injected and m-rope through B1 against the same call on
   B1's plain version (logits within 5 % of the largest, as phase 4); one
   image chat (TTFT split: PNG decode, preprocess, tower, the engine);
   the same image again (the same ids) and another image (other ids); 8
   concurrent chats mixing images and text (200s, usage counting each
   image's span), served with graph decode blocks and again with the eager
   block body (the same ids); a text request's ids equal to those of the
   same weights on a decoder without m-rope; (b) llava: the
   clip-vit-l-336 tower (24 layers at full depth, 577 positions, projector
   into 4096, random f32 weights) into llama-3-8b bf16 at full width and
   depth, `backend: llava`, over HTTP (usage counting 576 image tokens,
   the same image the same ids, another image other ids); (c) the tiny
   f32 Qwen2-VL of the CPU tests, its decoder widened to head dim 64 for
   B1, on the card against the CPU (prefill logits within 1e-4, greedy
   ids of an image and a text request exact).
   Generated ids are kept to printable ASCII (+100 on ids 32-126), so a
   reply's text is its ids under the byte tokenizer.
26. service (run after 25) — out-of-process backends and the service
   surfaces through the CLI's app (every layer the port registers) on the
   card: llama-3.2-1b (8 of 16 layers, bf16) written once to an HF
   checkpoint, imported through /models/import-uri and served in this
   process; a `subprocess` model whose child (`python -m
   localai_tpu_torch run --device cuda`) serves the same checkpoint on the
   card: spawn to ready, the first chat through the parent, warm chats and
   streams through the relay against the same ones straight to the child
   (the relay's cost in ms), greedy ids through the relay = straight from
   the child = the in-process model's, a stream, /v1/embeddings and
   /v1/tokenize relayed; SIGKILL of the child mid-stream: an error frame
   ends that stream, the in-process model still answers, the next request
   respawns the child (respawns 1) with the same ids, the card's free
   memory (before the spawn, with the child up, after the kill) shows the
   dead child's memory back, no kernel library rebuilt by the child; a
   `remote` model on this server's own port (the in-process ids) and one
   on a dead port (502, the server survives); a gallery install of a tiny
   f32 checkpoint over local HTTP, served on the card; one
   /mcp/v1/chat/completions against a stub MCP server on loopback through
   the 1b engine.
27. gguf_deepseek (run after 21) — a deepseek2 GGUF written from llama.cpp's
   layout at deepseek-v2-lite's full widths (4 of its 27 layers: the dense
   layer and 3 MoE layers; seeded random payloads mixed as a Q4_K_M file
   mixes them: q4_K / q8_0 experts, q6_K / q8_0 attention, a q6_K head):
   write and parse timed, the tree's forms (grouped int8 experts for B3's
   `gq` expert form, per-channel int8 head for B4), 8 requests through
   Engine.submit on the paged engine with graphs held to the dequantized
   bf16 tree (_part_gap's rule), then 4 chats over HTTP from a YAML
   `model: <file>.gguf`; each run's launches: B2's latent form, B3's gq
   expert form, B4. Phase 13 holds the gq expert form at E = 64.
28. expert_lora (run after 27) — a mixtral-8x7b HF checkpoint at full width
   (1 of 32 layers) with a rank-16 PEFT adapter on every expert's w1 / w3
   / w2 and on q_proj / v_proj, loaded int4 with the adapter merged: every
   merged int4 payload equal, bit for bit, to the pre-merged checkpoint's
   quantized as the loader does; 8 greedy requests through B3's expert
   form on both trees give the same ids.
29. audio (run after 28) — the port's audio and realtime layers on the
   card: whisper-large-v3 (full width and depth, bf16, a random checkpoint
   written by save_hf_whisper) over /v1/audio/transcriptions on 30 s and
   75 s of formant speech (1 and 3 chunks), its encoder held to the f32
   witness by cosine and its greedy ids equal or parting at a near tie;
   a VITS voice at MMS-TTS-eng's widths and tts-base over /v1/audio/speech
   and /v1/audio/speech/stream, the VITS waveform held to a CPU f32
   witness under the same noise; /v1/vad with the packaged learned VAD;
   one realtime round trip (server VAD, whisper, the 4-layer 1b's turn
   through B1 and B2, the VITS voice's pcm16), timed from the commit.
30. image (run after 29) — the port's image layer on the card: SD-1.5 at
   full width and depth (a bf16 diffusers checkpoint of seeded random
   weights) over /v1/images/generations at 512², 20 DDIM steps, CFG 7.5,
   n 1 and 4, b64_json and url (a repeated seed gives the same bytes),
   /v1/images/inpainting (multipart) and img2img, held to its f32 witness
   (UNet cosine, 4-step image |Δ|); SDXL base (depth cut: SDXL_TX_DEPTH,
   SDXL_TEXT2_LAYERS) at 1024² in 4 steps; Flux's loader on a 1-block
   checkpoint, then Flux.1-dev at full width and depth drawn on the card,
   1024² in 4 steps; AnimateDiff over /v1/videos (8 frames, 256²); the
   dit-test preset over the server and card against CPU. Its numbers print
   beside the card's name and power limit (`[image summary]`); B1-B5's
   counters stay 0 on this path.
In 5, 6, 8, 10, 11, 12, 14, 15, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28 and 29 (the
parent's engines; the child's launches are its own) the kernel launch counters, zeroed just
before each run, show that the path went through the kernels; a graph
replay counts the launches its capture recorded. Every decode block of
those runs is a graph capture or replay (the eager runs of phases 12 and
14 aside).

The last lines are the kernels' JSON record, the card's `nvidia-smi` name
and power limit, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# The card's published peaks (H100 SXM data sheet, dense): bf16 tensor-core
# rate, f32 rate outside the tensor cores, HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# llama-3.2-1b at 4 of its 16 layers: the depth every 1b phase runs (phases
# 4-6 at 8 from the start, the others cut from 16 to 8 for the run's time
# once phase 25 joined, all to 4 once phases 27-29 did), registered as an
# arch preset so the server's YAMLs can name it.
ONEB_LAYERS = 4
ONEB_PRESET = "llama-3.2-1b-4l"


def _arch_1b():
    """llama-3.2-1b's widths at ONEB_LAYERS layers, also registered as the
    arch preset ONEB_PRESET."""
    from localai_tpu_torch.models.config import PRESETS, get_arch

    cfg = dataclasses.replace(get_arch("llama-3.2-1b"), num_layers=ONEB_LAYERS)
    PRESETS.setdefault(ONEB_PRESET, cfg)
    return cfg


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_time_cold_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` calls by CUDA events, with the
    50 MB L2 cache flushed before each call (the serving path reads each
    layer's pages once per step, so it finds them cold). A device-side spin
    queued first lets the host enqueue the flush, the events and the call
    before the device reaches them, so host launch overhead stays out."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)  # about a millisecond of device time
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """module.name replaced by fn for the duration (a reference route)."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


# --------------------------------------------------------------------------- #
# 1. device
# --------------------------------------------------------------------------- #

def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} count={torch.cuda.device_count()} nvidia-smi: {smi} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    probe = {m: importlib.util.find_spec(m) is not None
             for m in ("yaml", "jinja2", "safetensors", "tokenizers", "transformers", "triton",
                       "regex", "PIL", "torchvision")}
    probe["ninja"] = shutil.which("ninja") is not None or importlib.util.find_spec("ninja") is not None
    log("[env-probe] " + json.dumps(probe, sort_keys=True))
    return name, smi


# --------------------------------------------------------------------------- #
# 2. build
# --------------------------------------------------------------------------- #

def _kernel_name(mangled: str) -> str:
    """`qmm_mma_kernel<2, 2, 1>` from a mangled kernel name (c++filt where the
    machine has it, else the mangled name)."""
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt:
        return mangled
    full = subprocess.run([cxxfilt, mangled], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    full = full.replace("(anonymous namespace)::", "").replace("void ", "")
    return full.split("(")[0] or mangled


def _ptxas_usage(out: str) -> list[dict]:
    """Registers, spill bytes and static shared memory of every kernel in an
    `nvcc -Xptxas -v` log."""
    rows, cur = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def phase_build() -> dict[str, list[dict]]:
    from localai_tpu_torch import kernels

    t0 = time.monotonic()
    logs = kernels.build()
    log(f"[build] {len(logs)} librar{'y' if len(logs) == 1 else 'ies'} in "
        f"{time.monotonic() - t0:.1f}s with {kernels.nvcc_path()}")
    usage = {}
    for name, out in logs.items():
        for line in out.splitlines():
            if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                    or "spill" in line):
                log(f"[build:{name}] {line.strip()}")
        check(kernels.library_path(name).exists(), f"library {name} missing after build")
        usage[name] = _ptxas_usage(out)
    b2 = [r for r in usage["paged_attention"] if "paged_" in r["kernel"]]
    log(f"[build:paged_attention] instances: {json.dumps(b2)}")
    check(sum("paged_mma_kernel" in r["kernel"] for r in b2) == 12
          and sum("paged_scalar_kernel" in r["kernel"] for r in b2) == 6
          and sum("paged_latent_kernel" in r["kernel"] for r in b2) == 3,
          f"expected 12 paged_mma_kernel, 6 paged_scalar_kernel and 3 paged_latent_kernel "
          f"instances, found {b2}")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0 for r in b2
              if "paged_mma_kernel" in r["kernel"] or "paged_latent_kernel" in r["kernel"]),
          f"a tensor-core paged_attention instance spills: {b2}")
    mma = [r for r in usage["quant_matmul"] if "qmm_mma_kernel" in r["kernel"]]
    log(f"[build:quant_matmul] tensor-core instances: {json.dumps(mma)}")
    check(len(mma) == 9, f"expected 9 qmm_mma_kernel instances in the ptxas log, found {len(mma)}")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0 for r in mma),
          f"a qmm_mma_kernel instance spills: {mma}")
    b4 = [r for r in usage["quant_matmul"] if "unembed_mma_kernel" in r["kernel"]]
    log(f"[build:quant_matmul] B4 tensor-core instances: {json.dumps(b4)}")
    check(len(b4) == 3, f"expected 3 unembed_mma_kernel instances in the ptxas log, found {b4}")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0 for r in b4),
          f"an unembed_mma_kernel instance spills: {b4}")
    b5 = [r for r in usage["lora_matmul"] if "lora_group_kernel" in r["kernel"]]
    log(f"[build:lora_matmul] instances: {json.dumps(b5)}")
    check(len(b5) == 4, f"expected 4 lora_group_kernel instances in the ptxas log, found {b5}")
    mma5 = [r for r in b5 if "__nv_bfloat16, __nv_bfloat16" in r["kernel"]]
    check(len(mma5) == 1 and mma5[0].get("spill_stores", 1) == 0
          and mma5[0].get("spill_loads", 1) == 0,
          f"the tensor-core lora_group_kernel instance is missing or spills: {b5}")
    return usage


# --------------------------------------------------------------------------- #
# 3. kernels
# --------------------------------------------------------------------------- #

def _attention_work(B, S, H, K, D, lengths, dtype) -> tuple[float, float]:
    """(FLOPs, bytes) the flash function needs on this data: QKᵀ and PV over
    the causal pairs of each row's valid prefix; the valid rows of q, k and
    v and the lengths read once, the whole output (padded rows as zeros)
    written once."""
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    flops = 4.0 * D * H * pairs
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * (sum(lengths) * (H + 2 * K) * D + B * S * H * D) + 4 * B
    return flops, nbytes


def phase_kernels(gen: torch.Generator) -> list[dict]:
    import torch.nn.functional as F

    from localai_tpu_torch.ops.flash import flash_prefill_attention, flash_prefill_attention_plain

    # Tolerances, bf16 output: both sides round once to bf16, whose step at
    # the outputs' magnitude (|o| < 4) is at most 2^-6; f32: summation order.
    tols = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    ragged = [  # (B, S, H, K, D, dtype): llama-3.2-1b admissions, then D=128
        (1, 128, 32, 8, 64, torch.bfloat16),
        (8, 128, 32, 8, 64, torch.bfloat16),
        (1, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 128, torch.bfloat16),
        (2, 256, 32, 8, 64, torch.float32),
    ]
    # Every row of length S: the kernel, SDPA and the bound count the same
    # work (llama-3.2-1b and llama-3-8b at 8 x 2048; the 8b admission
    # bucket of 8 x 512). S = 200: the last query and kv tiles are partial.
    full = [
        (8, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 128, torch.bfloat16),
        (8, 512, 32, 8, 128, torch.bfloat16),
    ]
    partial = [
        (3, 200, 32, 8, 64, torch.bfloat16),
        (3, 200, 32, 8, 128, torch.bfloat16),
        (3, 200, 32, 8, 64, torch.float32),
    ]
    # The embed_rerank phase's forwards on the 1b: 16 embeddings at bucket
    # 512, 32 rerank documents at bucket 2048.
    embed_rerank = [
        (16, 512, 32, 8, 64, torch.bfloat16),
        (32, 2048, 32, 8, 64, torch.bfloat16),
    ]
    # The vision phase's admissions on Qwen2-VL-2B (H 12, K 2, D 128): an
    # image chat at bucket 512 (a 448 x 448 image's 256 tokens and the
    # chat template) and the largest image's at bucket 2048, each row at
    # the path's length and at full length.
    vision = [((1, 512, 12, 2, 128, torch.bfloat16), 290),
              ((1, 512, 12, 2, 128, torch.bfloat16), "full"),
              ((1, 2048, 12, 2, 128, torch.bfloat16), 1314),
              ((1, 2048, 12, 2, 128, torch.bfloat16), "full")]
    # The added rows draw from their own generators, so the later phases
    # see the inputs they always saw.
    gen_added = torch.Generator(device="cuda").manual_seed(6)
    gen_vision = torch.Generator(device="cuda").manual_seed(22)
    cases = ([(sh, "ragged", gen) for sh in ragged] + [(sh, "full", gen_added) for sh in full]
             + [(sh, "ragged", gen_added) for sh in partial + embed_rerank]
             + [(sh, mode, gen_vision) for sh, mode in vision])
    rows = []
    for (B, S, H, K, D, dt), mode, g in cases:
        q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        if mode == "full":
            lens = torch.full((B,), S, device="cuda", dtype=torch.int32)
        elif isinstance(mode, int):  # the path's prompt length
            lens = torch.full((B,), mode, device="cuda", dtype=torch.int32)
        else:  # one full row, one single-token row, the rest ragged
            lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
            lens[0] = S
            if B > 1:
                lens[1] = 1
        out = flash_prefill_attention(q, k, v, lens)
        torch.cuda.synchronize()
        ref = flash_prefill_attention_plain(q, k, v, lens)
        err = (out.float() - ref.float()).abs().max().item()
        host_lens = lens.tolist()
        pad_zero = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(host_lens))
        # The same inputs again, and each batch row alone: the same bits
        # (no block mixes batch rows; nothing sums in a varying order).
        repeat_equal = torch.equal(out, flash_prefill_attention(q, k, v, lens))
        rows_alone_equal = all(
            torch.equal(out[b:b + 1], flash_prefill_attention(
                q[b:b + 1].contiguous(), k[b:b + 1].contiguous(), v[b:b + 1].contiguous(),
                lens[b:b + 1].contiguous()))
            for b in range(B))
        reps = 20 if S <= 256 else 5
        ms = cuda_time_ms(lambda: flash_prefill_attention(q, k, v, lens), reps)
        plain_ms = cuda_time_ms(lambda: flash_prefill_attention_plain(q, k, v, lens), max(2, reps // 4))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            reps)
        flops, nbytes = _attention_work(B, S, H, K, D, host_lens, dt)
        t_ops, t_bytes = flops / PEAK_FLOPS[dt] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        row = dict(shape=[B, S, H, K, D], dtype=str(dt).replace("torch.", ""),
                   lengths=host_lens, max_abs_err=err, tol=tols[dt],
                   pad_zero=pad_zero, repeat_equal=repeat_equal,
                   rows_alone_equal=rows_alone_equal,
                   ok=(err <= tols[dt] and pad_zero and repeat_equal and rows_alone_equal
                       and bool(torch.isfinite(out).all())),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   # SDPA computes every row at full length: the same work
                   # only where every length is S.
                   library_same_work=all(n == S for n in host_lens),
                   bound_ms=bound_ms, bound_frac=bound_ms / ms,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"[kernel flash_prefill] {json.dumps(row)}")
        check(row["ok"], f"flash_prefill disagrees with its plain version at {row['shape']} "
                         f"{row['dtype']}: err {err} (tol {tols[dt]}), padded rows zero={pad_zero}, "
                         f"repeat bit-identical={repeat_equal}, "
                         f"rows alone bit-identical={rows_alone_equal}")
        rows.append(row)
    return rows


def _paged_work(qpos, limits, K, D, MP, page, elt, window, sink=0, swin=0,
                span=0, latent=False) -> tuple[float, float]:
    """(FLOPs, bytes) the paged-partials function needs on this data: QKᵀ
    and PV over the unmasked (row, key) pairs of the rows each slot visits
    (its live rows, min(limit, MP·page); under the sink + window skip only
    the sink pages and the window's: ops/paged_flash.walk_rows); those K/V
    rows read once, the table entries of the visited pages (and with a
    hierarchical table the directory entries above them), q rows, limits
    and query positions read once, acc, m and l written once. The latent
    form reads each row once for both products (K is V)."""
    import numpy as np

    from localai_tpu_torch.ops.paged_flash import walk_rows

    B, QR = qpos.shape
    pairs = rows = entries = 0
    for b in range(B):
        n_v, sink_rows, gap = walk_rows(int(limits[b]), int(qpos[b].min()), page, MP, sink, swin)
        g = np.arange(n_v)
        g = np.where(g < sink_rows, g, g + gap)  # the real rows visited
        ok = np.ones((QR, n_v), bool)
        dist = qpos[b][:, None].astype(np.int64) - g[None, :]
        if window:
            ok &= dist < window
        if swin:
            ok &= (g[None, :] < sink) | (dist < swin)
        pairs += int(ok.sum())
        rows += n_v
        cols = np.unique(g // page)
        entries += len(cols) + (len(np.unique(cols // span)) if span else 0)
    flops = 4.0 * D * K * pairs
    nbytes = ((1 if latent else 2) * elt * rows * K * D + 4 * B * K * QR * D + 4 * entries + 4 * B
              + 4 * B * QR + 4 * B * K * QR * (D + 2))
    return flops, nbytes


def phase_paged_kernels(gen: torch.Generator) -> list[dict]:
    import numpy as np

    from localai_tpu_torch import kernels
    from localai_tpu_torch.models.llama import kv_cast
    from localai_tpu_torch.ops.paged_flash import (
        paged_partials_plain, paged_partials_rows, plan_for)

    # Both sides compute in f32 (pool rows widen exactly; the tensor-core
    # kernel splits q and p into bf16 hi + lo): the tolerance covers
    # summation order over up to 4096 rows and the hi / lo residue.
    tol = 2e-4
    # (name, B, G, T, K, D, page, MP, pool dtype, limits, softcap, window):
    # llama-3.2-1b paged decode (H=32, K=8: G=4 query rows per kv head) at
    # D 64 and 128, one 512-token prefill chunk at offset 1536, a small f32
    # shape with softcap and a sliding window, and the D=128 decode shape
    # (llama-3-8b's) on fp8 pools with a per-head kv_scale; then, from
    # their own generator, qwen2-7b's decode (H=28, K=4: G=7), pages of 16
    # and of 48 rows (key tiles span pages; 48-row pages put the split
    # edges, multiples of 128 rows, inside pages) with limits at a split
    # edge and one row either side, and a 4-token multi-query verify
    # (T*G = 16 rows).
    shapes = [
        ("decode", 8, 4, 1, 8, 64, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("decode", 8, 4, 1, 8, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("prefill_chunk", 1, 4, 512, 8, 64, 128, 32, torch.bfloat16, [1536], 0.0, 0),
        ("decode_softcap_window", 3, 2, 1, 2, 64, 16, 8, torch.float32, [100, 37, 0], 30.0, 40),
        ("decode_fp8", 8, 4, 1, 8, 128, 128, 32, torch.float8_e4m3fn, "ragged", 0.0, 0),
        ("decode_fp8", 8, 4, 1, 8, 128, 128, 32, torch.float8_e5m2, "ragged", 0.0, 0),
    ]
    added = [
        ("decode_g7", 8, 7, 1, 4, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("decode_page16", 8, 4, 1, 8, 64, 16, 256, torch.bfloat16,
         [4096, 0, 256, 255, 257, 1024, 1, 3000], 0.0, 0),
        ("decode_page48", 8, 4, 1, 8, 64, 48, 84, torch.bfloat16,
         [4032, 0, 384, 383, 385, 2049, 47, 3000], 0.0, 0),
        ("verify_t4", 8, 4, 4, 8, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        # llama-3-8b's speculative verify chunks on its fp8 pool: kb + 1 = 3
        # and 6 tokens (n_draft 5's buckets), T*G = 12 and 24 rows a kv head.
        ("verify_t3", 8, 4, 3, 8, 128, 128, 32, torch.float8_e4m3fn, "ragged", 0.0, 0),
        ("verify_t6", 8, 4, 6, 8, 128, 128, 32, torch.float8_e4m3fn, "ragged", 0.0, 0),
        # Qwen2-VL-2B's decode (H = 12, K = 2: G = 6 at D = 128), bf16 pool.
        ("decode_g6_qwen2vl", 8, 6, 1, 2, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
    ]
    gen_added = torch.Generator(device="cuda").manual_seed(8)
    sms = kernels.sm_count(torch.device("cuda"))
    rows = []
    for (name, B, G, T, K, D, page, MP, dt, limits, softcap, window), g in (
            [(sh, gen) for sh in shapes] + [(sh, gen_added) for sh in added]):
        QR = G * T
        P = B * MP + 1
        if limits == "ragged":  # one full slot, one idle slot, the rest random
            limits = torch.randint(1, MP * page + 1, (B,), generator=g, device="cuda").tolist()
            limits[0], limits[1] = MP * page, 0
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        qr = torch.randn(B, K, QR, D, generator=g, device="cuda") / D**0.5
        kp = torch.randn(P, page, K, D, generator=g, device="cuda")
        vp = torch.randn(P, page, K, D, generator=g, device="cuda")
        kv_scale = None
        if dt.itemsize == 1:  # fp8: stored = value / scale, a fixed per-head scale
            kv_scale = torch.stack([torch.linspace(0.5, 4.0, K), torch.linspace(3.0, 0.25, K)])
            kv_scale = kv_scale.cuda()
            kp, vp = kp / kv_scale[0][:, None], vp / kv_scale[1][:, None]
        kp, vp = kv_cast(kp, dt), kv_cast(vp, dt)
        # A random permutation of the pool's pages (SCRATCH, the last, unused).
        table = torch.randperm(P - 1, generator=g, device="cuda")[: B * MP]
        table = table.reshape(B, MP).to(torch.int32).contiguous()
        qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
        args = (qr, qpos, kp, vp, table, lim, softcap, window, kv_scale)
        acc, m, l = paged_partials_rows(*args)
        torch.cuda.synchronize()
        racc, rm, rl = paged_partials_plain(*args)
        live = lim > 0
        o_err = (acc / l.clamp(min=1e-30)[..., None] - racc / rl.clamp(min=1e-30)[..., None])
        o_err = o_err[live].abs().max().item()
        m_err = (m - rm)[live].abs().max().item()
        l_rel = ((l - rl)[live].abs() / rl[live]).max().item()
        idle_exact = bool((m[~live] == -1e30).all() and (l[~live] == 0).all()
                          and (acc[~live] == 0).all())
        # The same inputs again, and each slot launched alone: the same bits
        # (no float atomics; the plan does not depend on the batch).
        again = paged_partials_rows(*args)
        repeat_equal = all(torch.equal(a, b) for a, b in zip((acc, m, l), again))
        alone_equal = all(
            all(torch.equal(a[b:b + 1], x) for a, x in zip((acc, m, l), paged_partials_rows(
                qr[b:b + 1], qpos[b:b + 1], kp, vp, table[b:b + 1], lim[b:b + 1], softcap,
                window, kv_scale)))
            for b in range(B))
        plan = plan_for(qr, kp, table, sms)
        ms = cuda_time_cold_ms(lambda: paged_partials_rows(*args), 20)
        plain_ms = cuda_time_cold_ms(lambda: paged_partials_plain(*args), 3)
        flops, nbytes = _paged_work(qpos.cpu().numpy(), np.asarray(limits), K, D, MP, page,
                                    dt.itemsize, window)
        nbytes += 0 if kv_scale is None else kv_scale.numel() * 4
        # bf16 / fp8 pools: the least time is the tensor cores' (K and V
        # are exact in bf16); f32 pools: the f32 rate (q rows are f32).
        rate = torch.float32 if dt == torch.float32 else torch.bfloat16
        t_ops, t_bytes = flops / PEAK_FLOPS[rate] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=name, B=B, H=G * K, K=K, QR=QR, D=D, page=page, MP=MP,
                   pool_dtype=str(dt).replace("torch.", ""), limits=limits, softcap=softcap,
                   window=window,
                   kv_scale=None if kv_scale is None else kv_scale.tolist(),
                   max_abs_err=o_err, m_err=m_err, l_rel_err=l_rel, tol=tol,
                   idle_exact=idle_exact, repeat_equal=repeat_equal, alone_equal=alone_equal,
                   ok=max(o_err, m_err, l_rel) <= tol and idle_exact and repeat_equal
                   and alone_equal and bool(torch.isfinite(acc).all()),
                   plan={**plan._asdict(), "grid": [plan.splits, K * -(-QR // plan.row_tile), B]},
                   ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=max(t_ops, t_bytes), bound_frac=max(t_ops, t_bytes) / ms,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_basis=("FLOPs over the f32 rate (f32 pool: scalar FMAs)"
                                if rate == torch.float32 else
                                "FLOPs over the bf16 tensor-core peak (bf16 / fp8 pool)")
                   + ", bytes over HBM")
        log(f"[kernel paged_attention] {json.dumps(row)}")
        check(row["ok"], f"paged_attention disagrees with its plain version at {name} "
                         f"D={D} {row['pool_dtype']}: acc/l err {o_err}, m err {m_err}, "
                         f"l rel err {l_rel} (tol {tol}), idle exact={idle_exact}, "
                         f"repeat bit-identical={repeat_equal}, "
                         f"slots alone bit-identical={alone_equal}")
        rows.append(row)
    return rows + _long_context_kernel_rows()


def _hier_of(table: torch.Tensor, span: int, scratch: int):
    """A flat table [B, MP] as the engine's hierarchical pair: l0 row 0 the
    table page of SCRATCH entries, then each slot's table pages in order;
    l1 the directories [B, MP / span]."""
    B, MP = table.shape
    l0 = torch.cat([torch.full((1, span), scratch, dtype=torch.int32, device=table.device),
                    table.reshape(B * MP // span, span)])
    l1 = 1 + torch.arange(B * MP // span, dtype=torch.int32, device=table.device)
    return l1.reshape(B, MP // span).contiguous(), l0.contiguous()


# The long-context engine of the reference's ladder (bench.py:2099-2118):
# pages of 128, sink 128, window 4096, table pages of 128 entries.
LONG_SINK, LONG_WINDOW, LONG_SPAN = 128, 4096, 128


def _long_context_kernel_rows() -> list[dict]:
    """B2's long-context forms against the plain version, on the card:
    llama-3.2-1b's decode shape (B = 8, K = 8, G = 4, D = 64, pages of
    128) at contexts up to 131072 and a 512-token chunk at offset 65536
    (past the window), each on a hierarchical table under the sink +
    window skip; then one slot at a 1,048,576-token limit whose pool holds
    only the pages it visits and SCRATCH. Each holds the hierarchical table
    to the flat one and a spilled table (skipped columns at SCRATCH) to the
    hot one bit for bit, repeats and slots alone bit for bit, and times the
    kernel, the plain version, and the same slots walked in full without
    the skip. The bound counts the visited rows' bytes only."""
    import numpy as np

    from localai_tpu_torch import kernels
    from localai_tpu_torch.ops.paged_flash import (
        paged_partials_plain, paged_partials_rows, plan_for, walk_rows)

    tol = 2e-4  # as the other B2 rows: f32 on both sides
    g = torch.Generator(device="cuda").manual_seed(13)
    sms = kernels.sm_count(torch.device("cuda"))
    sink, swin, span = LONG_SINK, LONG_WINDOW, LONG_SPAN
    rows = []
    for name, B, T, MP, limits in (
            ("decode_128k_hier_skip", 8, 1, 1024, "ragged"),
            ("chunk_512_past_window_hier_skip", 1, 512, 1024, [65536]),
            ("decode_1m_hier_skip", 1, 1, 8192, [1 << 20])):
        K, G, D, page = 8, 4, 64, 128
        QR = G * T
        if limits == "ragged":  # one full slot, one idle slot, the rest random
            limits = torch.randint(1, MP * page + 1, (B,), generator=g, device="cuda").tolist()
            limits[0], limits[1] = MP * page, 0
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
        walks = [walk_rows(n, n, page, MP, sink, swin) for n in limits]
        million = MP * page > 131072
        if million:
            # The pool holds the pages the slot visits, then SCRATCH; every
            # other column of the table points at SCRATCH.
            n_v, sink_rows, gap = walks[0]
            cols = sorted({c // page for c in range(sink_rows)}
                          | set(range((sink_rows + gap) // page, -(-limits[0] // page))))
            P = len(cols) + 1
            table = torch.full((1, MP), P - 1, dtype=torch.int32, device="cuda")
            table[0, cols] = torch.arange(len(cols), dtype=torch.int32, device="cuda")
        else:
            P = B * MP + 1
            table = torch.randperm(P - 1, generator=g, device="cuda")[: B * MP]
            table = table.reshape(B, MP).to(torch.int32).contiguous()
        kp = torch.randn(P, page, K, D, generator=g, device="cuda").to(torch.bfloat16)
        vp = torch.randn(P, page, K, D, generator=g, device="cuda").to(torch.bfloat16)
        qr = torch.randn(B, K, QR, D, generator=g, device="cuda") / D**0.5
        hier = _hier_of(table, span, P - 1)
        spilled = table.clone()
        for b, (n_v, sink_rows, gap) in enumerate(walks):
            spilled[b, sink_rows // page:(sink_rows + gap) // page] = P - 1
        args = (qr, qpos, kp, vp, hier, lim, 0.0, 0, None, sink, swin)
        before = paged_partials_rows.launches
        acc, m, l = out = paged_partials_rows(*args)
        torch.cuda.synchronize()
        launched = paged_partials_rows.launches - before
        racc, rm, rl = paged_partials_plain(*args)
        live = lim > 0
        o_err = (acc / l.clamp(min=1e-30)[..., None] - racc / rl.clamp(min=1e-30)[..., None])
        o_err = o_err[live].abs().max().item()
        m_err = (m - rm)[live].abs().max().item()
        l_rel = ((l - rl)[live].abs() / rl[live]).max().item()

        def same(x, y):
            return all(torch.equal(a, c) for a, c in zip(x, y))

        hier_equal_flat = same(out, paged_partials_rows(qr, qpos, kp, vp, table, lim, 0.0, 0,
                                                         None, sink, swin))
        spilled_equal_hot = same(out, paged_partials_rows(
            qr, qpos, kp, vp, _hier_of(spilled, span, P - 1), lim, 0.0, 0, None, sink, swin))
        repeat_equal = same(out, paged_partials_rows(*args))
        alone_equal = all(same([a[b:b + 1] for a in out], paged_partials_rows(
            qr[b:b + 1], qpos[b:b + 1], kp, vp, (hier[0][b:b + 1], hier[1]), lim[b:b + 1],
            0.0, 0, None, sink, swin)) for b in range(B))
        plan = plan_for(qr, kp, hier, sms)
        ms = cuda_time_cold_ms(lambda: paged_partials_rows(*args), 20)
        plain_ms = cuda_time_cold_ms(lambda: paged_partials_plain(*args), 3)
        # The same slots walked in full (no skip; every row attended): what
        # a slot costs without the window. The 1M slot's pool holds too few
        # pages for that.
        full_ms = None if million else cuda_time_cold_ms(
            lambda: paged_partials_rows(qr, qpos, kp, vp, hier, lim), 20)
        flops, nbytes = _paged_work(qpos.cpu().numpy(), np.asarray(limits), K, D, MP, page, 2,
                                    0, sink, swin, span)
        t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=name, form="hierarchical table + sink/window skip", B=B, H=G * K, K=K,
                   QR=QR, D=D, page=page, MP=MP, span=span, sink=sink, swin=swin, pool_pages=P,
                   pool_dtype="bfloat16", limits=limits,
                   visited_rows=[w[0] for w in walks], launches=launched,
                   max_abs_err=o_err, m_err=m_err, l_rel_err=l_rel, tol=tol,
                   hier_equal_flat=hier_equal_flat, spilled_equal_hot=spilled_equal_hot,
                   repeat_equal=repeat_equal, alone_equal=alone_equal,
                   ok=max(o_err, m_err, l_rel) <= tol and hier_equal_flat and spilled_equal_hot
                   and repeat_equal and alone_equal and launched == 1
                   and bool(torch.isfinite(acc).all()),
                   plan={**plan._asdict(), "grid": [plan.splits, K * -(-QR // plan.row_tile), B]},
                   ms=ms, plain_ms=plain_ms, full_walk_ms=full_ms, library_ms=None,
                   bound_ms=max(t_ops, t_bytes), bound_frac=max(t_ops, t_bytes) / ms,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_basis="FLOPs over the bf16 tensor-core peak, the visited rows' bytes "
                               "over HBM")
        log(f"[kernel paged_attention long] {json.dumps(row)}")
        check(row["ok"], f"paged_attention {name}: acc/l err {o_err}, m err {m_err}, l rel err "
                         f"{l_rel} (tol {tol}), hier = flat {hier_equal_flat}, spilled = hot "
                         f"{spilled_equal_hot}, repeat {repeat_equal}, alone {alone_equal}, "
                         f"launches {launched}")
        rows.append(row)
        del kp, vp, out, acc, racc
        torch.cuda.empty_cache()
    return rows


# llama-3-8b's projections (in, out): wk / wv, wq / wo, w_gate / w_up,
# w_down; then a small ragged shape (three int4 groups, out not a multiple
# of the kernel's 128-column block).
QMM_SHAPES = [(4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096), (96, 80)]
QMM_FORMS = ("int8", "grouped_int8", "int4")


def _grouped_int8(w, group=32):
    """Group-wise symmetric int8 (GGUF q8_0's layout) over the in (-2) axis,
    leading (expert) axes kept, quantized here: the serving path's
    quantizers make the flat int8 and int4 forms only."""
    g = w.shape[-2] // group
    wg = w.float().reshape(*w.shape[:-2], g, group, w.shape[-1])
    s = torch.clamp(wg.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-9)
    return {"gq": torch.clamp(torch.round(wg / s), -127, 127).to(torch.int8), "gs": s}


def _qmm_work(form, N, n_in, n_out, x_elt) -> tuple[float, float]:
    """(FLOPs, bytes) of x [N, in] @ w: the payload, its scales (and int4
    zero points) and x read once, the output written once."""
    G = n_in // 32
    wbytes = {"int8": n_in * n_out + 4 * n_out,
              "grouped_int8": n_in * n_out + 4 * G * n_out,
              "int4": n_in * n_out // 2 + 8 * G * n_out}[form]
    return 2.0 * N * n_in * n_out, wbytes + x_elt * N * (n_in + n_out)


def _bound(flops, nbytes, dtype) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _hold_b3(label: str, run, plain, x, bf16_mm, dequant, work, plan, **keys) -> dict:
    """One B3 row: the kernel `run(x)` against its plain version (f32 x:
    summation order only, 1e-4 x max|out|; bf16 x: both sides round the f32
    sum once to bf16, so they may differ by one bf16 step, 2^-7 of the
    value, plus that term), a second launch bit-identical and, up to 16
    rows, each row launched alone bit-identical; flushed times of the
    kernel, the plain version, `bf16_mm()` and `dequant(x)` with the kernel
    route off, and the bound of `work` = (FLOPs, bytes)."""
    dt, N = x.dtype, x.shape[0]
    out = run(x)
    torch.cuda.synchronize()
    want = plain(x)
    scale = plain(x.float()).abs().max().item()
    err = (out.float() - want.float()).abs()
    if dt == torch.float32:
        ok = err.max().item() <= 1e-4 * scale
    else:
        ok = bool((err <= 2.0**-7 * want.float().abs() + 1e-4 * scale).all())
    ok = ok and bool(torch.isfinite(out).all())
    repeat_equal = torch.equal(out, run(x))
    rows_alone_equal = (all(torch.equal(out[i:i + 1], run(x[i:i + 1])) for i in range(N))
                        if N <= 16 else None)
    ms = cuda_time_cold_ms(lambda: run(x), 20)
    plain_ms = cuda_time_cold_ms(lambda: plain(x), 3)
    bf16_ms = cuda_time_cold_ms(bf16_mm, 20)
    with _dequant_route():
        dequant_ms = cuda_time_cold_ms(lambda: dequant(x), 20)
    bound_ms, bound_by = _bound(*work, dt)
    row = dict(**keys, dtype=str(dt).replace("torch.", ""), max_abs_err=err.max().item(),
               out_max=scale, repeat_equal=repeat_equal, rows_alone_equal=rows_alone_equal,
               ok=ok and repeat_equal and rows_alone_equal is not False, ms=ms,
               plain_ms=plain_ms, bf16_ms=bf16_ms, dequant_ms=dequant_ms, bound_ms=bound_ms,
               bound_frac=bound_ms / ms, bound_by=bound_by, plan=plan)
    log(f"[kernel {label}] {json.dumps(row)}")
    check(row["ok"], f"{label} disagrees with its plain version or is not bit-identical on a "
                     f"repeat / a row alone at {row}")
    return row


def phase_quant_kernels(gen: torch.Generator) -> tuple[list[dict], list[dict]]:
    """B3 at every projection shape, form, x dtype and row count of the
    serving path, and B4 at llama-3-8b's head and a ragged one
    (_hold_unembed); each against its plain
    version, with the time of a bf16 matmul on the dequantized weight
    (`bf16_ms`: what the quantized kernel has to beat to be worth its
    bytes) and, for B3, of models/quant.matmul with the kernel route off
    (`dequant_ms`: what the engine pays at those rows without B3). Every B3
    output is bit-identical when launched again, and up to 16 rows for each
    row launched alone. No one PyTorch call takes these packed layouts, so
    there is no library time."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops.quant_matmul import qmm, qmm_plain, qmm_plan

    # f32 x: summation order only. bf16 x: both sides round the f32 sum once
    # to bf16, so they may differ by one bf16 step (2^-7 of the value).
    # The 16- and 64-row inputs draw from their own generator, so the later
    # phases see the inputs they always saw.
    gen_added = torch.Generator(device="cuda").manual_seed(7)
    b3 = []
    for n_in, n_out in QMM_SHAPES:
        w = torch.randn(n_in, n_out, generator=gen, device="cuda") * 0.02
        for form in QMM_FORMS:
            qw = {"int8": quant.quantize_tensor, "grouped_int8": _grouped_int8,
                  "int4": quant.quantize_tensor_g4}[form](w)
            w_bf16 = quant.dequantize_tensor(qw).to(torch.bfloat16)
            for dt in (torch.bfloat16, torch.float32):
                for N in (1, 8, 16, 64, 256):
                    g = gen if N in (1, 8, 256) else gen_added
                    x = torch.randn(N, n_in, generator=g, device="cuda").to(dt)
                    xb = x.to(torch.bfloat16)
                    plan = (qmm_plan(n_in, n_out, N, kernels.sm_count(x.device))._asdict()
                            if dt == torch.bfloat16 else None)
                    b3.append(_hold_b3(
                        "quant_matmul", lambda v: qmm(v, qw), lambda v: qmm_plain(v, qw), x,
                        lambda: torch.matmul(xb, w_bf16), lambda v: quant.matmul(v, qw),
                        _qmm_work(form, N, n_in, n_out, dt.itemsize), plan,
                        shape=[N, n_in, n_out], form=form))
            del qw, w_bf16
    b4 = []
    # llama-3-8b's head, then a ragged one (V not a multiple of a 16-row
    # vocab tile, D = 16 * 5: a last chunk of 16 columns) from gen_added.
    for V, D in ((128256, 4096), (1000, 80)):
        g_head = gen if V == 128256 else gen_added
        w = torch.randn(V, D, generator=g_head, device="cuda") * 0.02
        s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-9)
        head = {"q": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "s": s}
        head_bf16 = (head["q"].float() * s).to(torch.bfloat16)
        del w
        for dt in (torch.bfloat16, torch.float32):
            for N in (1, 8, 16, 64, 256):
                g = gen if V == 128256 and N in (1, 8, 256) else gen_added
                h = torch.randn(N, D, generator=g, device="cuda").to(dt)
                b4.append(_hold_unembed(h, head, head_bf16))
        del head, head_bf16
    return b3, b4


def _hold_unembed(h, head, head_bf16) -> dict:
    """One B4 row: the kernel against its plain version (f32 on both sides,
    exact bf16 x int8 products: summation order only, 1e-4 x max|logit|),
    a second launch bit-identical and, up to 16 bf16 rows, each row launched
    alone bit-identical; times beside a bf16 matmul on the dequantized head."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.ops.quant_matmul import qunembed, qunembed_plain, qunembed_plan

    N, D = h.shape
    V = head["q"].shape[0]
    dt = h.dtype
    out = qunembed(h, head)
    torch.cuda.synchronize()
    want = qunembed_plain(h, head)
    scale = want.abs().max().item()
    err = (out - want).abs().max().item()
    ok = err <= 1e-4 * scale and bool(torch.isfinite(out).all())
    repeat_equal = torch.equal(out, qunembed(h, head))
    rows_alone_equal = (all(torch.equal(out[i:i + 1], qunembed(h[i:i + 1], head))
                            for i in range(N)) if dt == torch.bfloat16 and N <= 16 else None)
    hb = h.to(torch.bfloat16)
    ms = cuda_time_cold_ms(lambda: qunembed(h, head), 20)
    plain_ms = cuda_time_cold_ms(lambda: qunembed_plain(h, head), 3)
    bf16_ms = cuda_time_cold_ms(
        lambda: torch.mm(hb, head_bf16.t(), out_dtype=torch.float32), 20)
    bound_ms, bound_by = _bound(2.0 * N * V * D,
                                V * D + 4 * V + dt.itemsize * N * D + 4 * N * V, dt)
    plan = (qunembed_plan(V, D, N, kernels.sm_count(h.device))._asdict()
            if dt == torch.bfloat16 else None)
    row = dict(shape=[N, V, D], dtype=str(dt).replace("torch.", ""), max_abs_err=err,
               out_max=scale, repeat_equal=repeat_equal, rows_alone_equal=rows_alone_equal,
               ok=ok and repeat_equal and rows_alone_equal is not False, ms=ms,
               plain_ms=plain_ms, bf16_ms=bf16_ms, bound_ms=bound_ms, bound_frac=bound_ms / ms,
               bound_by=bound_by, plan=plan)
    log(f"[kernel quant_unembed] {json.dumps(row)}")
    check(row["ok"], f"quant_unembed disagrees with its plain version or is not bit-identical "
                     f"on a repeat / a row alone at {row}")
    return row


# --------------------------------------------------------------------------- #
# 4. model
# --------------------------------------------------------------------------- #

def _greedy_decode(cfg, params, logits, ks, vs, lens, steps, device):
    """Greedy ids over `steps` decode steps after a prefill, one block."""
    from localai_tpu_torch.models import llama

    B = lens.shape[0]
    cache = llama.KVCache.zeros(cfg, B, int(lens.max()) + steps + 1, device=device)
    for b in range(B):
        llama.write_prefill_to_cache(cache, ks[:, b:b + 1], vs[:, b:b + 1], b)
    shape = (cfg.num_layers, B, steps, cfg.num_kv_heads, cfg.head_dim_)
    lk = torch.zeros(shape, dtype=cache.k.dtype, device=device)
    lv = torch.zeros_like(lk)
    tok, pos, ids = logits.argmax(-1), lens.to(torch.int64), []
    for step in range(steps):
        out, lk, lv = llama.decode_step_windowed(cfg, params, tok, pos, cache, lk, lv, step)
        tok = out.argmax(-1)
        ids.append(tok.tolist())
        pos = pos + 1
    return ids


def _paged_greedy(cfg, params, toks, lens, steps, device):
    """Each prompt through prefill_chunk_paged in 32-token chunks into one
    page pool (page 16, a reversed page table), then one paged decode block
    of `steps` greedy steps. Returns (prefill logits [B, V], the last step's
    logits, greedy ids)."""
    from localai_tpu_torch.models import llama

    B, page, chunk = toks.shape[0], 16, 32
    MP = -(-(int(lens.max()) + steps + 1) // page)
    pool = llama.paged_cache_zeros(cfg, B * MP + 1, page, device=device)
    table = torch.arange(B * MP, dtype=torch.int32).flip(0).reshape(B, MP).to(device)
    first = []
    for b in range(B):
        n = int(lens[b])
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            logits, _ = llama.prefill_chunk_paged(
                cfg, params, toks[b:b + 1, lo:lo + m].to(device), torch.tensor([m], device=device),
                torch.tensor([lo], device=device), pool, table[b:b + 1])
        first.append(logits)
    logits = torch.cat(first)
    shape = (cfg.num_layers, B, steps, cfg.num_kv_heads, cfg.head_dim_)
    lk = torch.zeros(shape, dtype=pool.k.dtype, device=device)
    lv = torch.zeros_like(lk)
    tok, pos, ids = logits.argmax(-1), lens.to(device=device, dtype=torch.int64), []
    for step in range(steps):
        out, lk, lv = llama.decode_step_windowed(cfg, params, tok, pos, pool, lk, lv, step,
                                                 ptable=table)
        tok = out.argmax(-1)
        ids.append(tok.tolist())
        pos = pos + 1
    return logits, out, ids


def phase_model(gen: torch.Generator) -> dict:
    from localai_tpu_torch.models import get_arch, llama

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 reference: full f32 products
    # (a) A small f32 model (head_dim 64, so the kernel serves it) on the
    # card against the same weights on the CPU.
    small = dataclasses.replace(get_arch("tiny"), name="tiny-d64", hidden_size=256,
                                intermediate_size=512, num_heads=4, num_kv_heads=2,
                                dtype="float32")
    p_cpu = llama.init_params(small, seed=1, device="cpu")
    p_gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    toks = torch.randint(0, small.vocab_size, (2, 64), generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([64, 23])
    lg, kg, vg = llama.prefill(small, p_gpu, toks.cuda(), lens.cuda())
    lc, kc, vc = llama.prefill(small, p_cpu, toks, lens)
    small_err = (lg.cpu() - lc).abs().max().item()
    ids_gpu = _greedy_decode(small, p_gpu, lg, kg, vg, lens.cuda(), 16, "cuda")
    ids_cpu = _greedy_decode(small, p_cpu, lc, kc, vc, lens, 16, "cpu")
    log(f"[model tiny-d64 f32] card vs cpu: logits max_abs_err={small_err:.3e} "
        f"greedy ids equal over 16 steps={ids_gpu == ids_cpu}")
    # f32 on both devices; only the summation order differs.
    check(small_err < 1e-3, f"small model: card logits differ from the CPU's by {small_err}")
    check(ids_gpu == ids_cpu, "small model: greedy ids differ between card and CPU")
    # The same model's paged path: chunked prefill into pages, paged decode.
    from localai_tpu_torch.ops.paged_flash import paged_partials_rows

    before = paged_partials_rows.launches
    pl_gpu, pd_gpu, pids_gpu = _paged_greedy(small, p_gpu, toks, lens, 16, "cuda")
    card_launches = paged_partials_rows.launches - before
    pl_cpu, pd_cpu, pids_cpu = _paged_greedy(small, p_cpu, toks, lens, 16, "cpu")
    paged_err = max((pl_gpu.cpu() - pl_cpu).abs().max().item(),
                    (pd_gpu.cpu() - pd_cpu).abs().max().item())
    log(f"[model tiny-d64 f32 paged] card vs cpu: prefill_chunk_paged + paged decode logits "
        f"max_abs_err={paged_err:.3e}, greedy ids equal over 16 steps={pids_gpu == pids_cpu}, "
        f"paged kernel launches on the card={card_launches}")
    check(paged_err < 1e-3, f"small model paged path: card logits differ by {paged_err}")
    check(pids_gpu == pids_cpu, "small model paged path: greedy ids differ between card and CPU")
    check(card_launches == small.num_layers * (3 + 16),
          f"small model paged path: {card_launches} paged kernel launches")

    # (b) Full-width llama-3.2-1b, bf16, random weights: the prefill through
    # the kernel against the same call through the dense attention, at 8 of
    # its 16 layers (ONEB_LAYERS, as every 1b phase) for the run's time.
    cfg = _arch_1b()
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[model llama-3.2-1b, {ONEB_LAYERS} layers] random bf16 weights in {time.monotonic() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    B, S = 2, 512
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    lens = torch.tensor([S, 300], device="cuda")
    logits, ks, vs = llama.prefill(cfg, params, toks, lens)
    from localai_tpu_torch.ops import attention

    def dense(q, k, v, length_mask, lengths=None, **kw):
        return attention.causal_prefill_attention(q, k, v, length_mask, **kw)

    with swapped(llama, "prefill_attention", dense):  # the same call through dense math
        ref, rks, rvs = llama.prefill(cfg, params, toks, lens)
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(logits).all()) and logits.shape == (B, cfg.vocab_size),
          "llama-3.2-1b prefill logits not finite / wrong shape")
    ids = _greedy_decode(cfg, params, logits, ks, vs, lens, 16, "cuda")
    ref_ids = _greedy_decode(cfg, params, ref, rks, rvs, lens, 16, "cuda")
    agree = sum(a == b for x, y in zip(ids, ref_ids) for a, b in zip(x, y)) / (16 * B)
    log(f"[model llama-3.2-1b bf16, {ONEB_LAYERS} layers] kernel vs dense prefill: logits max_abs_err={err:.4f} "
        f"(max |logit| {scale:.3f}), top-1 agreement={top1:.2f}, greedy ids over 16 steps "
        f"agree {agree:.2f}; kernel-path ids row0={[x[0] for x in ids]}")
    # bf16 activations through the layers: the two attentions round at
    # different places; allow 5% of the largest logit.
    check(err <= 0.05 * scale, f"llama-3.2-1b prefill logits differ by {err} (max {scale})")
    return {"params": params, "cfg": cfg, "small": small, "p_small": p_gpu, "p_small_cpu": p_cpu}


# --------------------------------------------------------------------------- #
# 7. quantized model, 8. quantized engines
# --------------------------------------------------------------------------- #

def _dequant_route():
    """Every quantized product through the dequantize-then-matmul route."""
    from localai_tpu_torch.ops import quant_matmul

    stack = contextlib.ExitStack()
    stack.enter_context(swapped(quant_matmul, "dispatch_matmul", lambda x, w: None))
    stack.enter_context(swapped(quant_matmul, "dispatch_moe_mm", lambda x, w, sub: None))
    stack.enter_context(swapped(quant_matmul, "dispatch_unembed", lambda h, w: None))
    return stack


def _f32_activations(qp: dict) -> dict:
    """A quantized tree whose float leaves (embedding, norms) are f32, so
    the forward runs in f32 on the same quantized weights."""
    out = {k: (v.float() if isinstance(v, torch.Tensor) else v) for k, v in qp.items()}
    out["layers"] = {k: (v if isinstance(v, dict) else v.float()) for k, v in qp["layers"].items()}
    return out


def phase_quant_model(gen: torch.Generator) -> dict:
    """llama-3-8b with seeded random bf16 weights, quantized on the card to
    int8 and int4: prefill and greedy decode through the kernels against the
    same quantized weights through the dequantize-then-matmul route, in
    bf16 and then with f32 activations."""
    from localai_tpu_torch.models import get_arch, llama, quant

    cfg = get_arch("llama-3-8b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[model llama-3-8b] random bf16 weights in {time.monotonic() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    out = {"cfg": cfg}
    prompts = {}
    for B, S in ((2, 128), (2, 512)):  # 256 rows: the kernels; 1024: the dequant route
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
        prompts[S] = (toks, torch.tensor([S, S - 37], device="cuda"))
    bf16_top1 = {S: llama.prefill(cfg, params, *prompts[S])[0].argmax(-1) for S in prompts}
    for mode in ("int8", "int4"):
        t0 = time.monotonic()
        before = torch.cuda.memory_allocated()
        qp = quant.quantize_params(cfg, params, mode)
        torch.cuda.synchronize()
        qbytes = sum(t.numel() * t.element_size()
                     for w in [*qp["layers"].values(), qp["lm_head"]] if isinstance(w, dict)
                     for t in w.values())
        log(f"[model llama-3-8b {mode}] quantized on the card in {time.monotonic() - t0:.1f}s: "
            f"matmul weights + head {qbytes / 2**30:.2f} GiB, "
            f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB more allocated, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in all")
        for S, (toks, lens) in prompts.items():
            launches = quant.matmul.dequant_calls
            logits, ks, vs = llama.prefill(cfg, qp, toks, lens)
            routed = quant.matmul.dequant_calls - launches
            with _dequant_route():
                ref, rks, rvs = llama.prefill(cfg, qp, toks, lens)
            check(bool(torch.isfinite(logits).all()) and logits.shape == (2, cfg.vocab_size),
                  f"llama-3-8b {mode} prefill logits not finite / wrong shape")
            err = (logits - ref).abs().max().item()
            scale = ref.abs().max().item()
            ids = _greedy_decode(cfg, qp, logits, ks, vs, lens, 16, "cuda")
            with _dequant_route():
                ref_ids = _greedy_decode(cfg, qp, ref, rks, rvs, lens, 16, "cuda")
            agree = sum(a == b for x, y in zip(ids, ref_ids) for a, b in zip(x, y)) / 32
            top1_bf16 = (logits.argmax(-1) == bf16_top1[S]).float().mean().item()
            row = dict(mode=mode, B=2, S=S, rows=2 * S, dequant_calls_in_prefill=routed,
                       max_abs_err=err, max_abs_logit=scale,
                       mean_abs_err=(logits - ref).abs().mean().item(),
                       top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                       greedy_agreement=agree, top1_vs_bf16=top1_bf16,
                       ids_row0=[x[0] for x in ids])
            log(f"[model llama-3-8b {mode}] kernels vs dequant route: {json.dumps(row)}")
            # Same quantized weights; the routes round bf16 activations at
            # other places (the kernels once per product, the dequant route
            # after the product and again after its bf16-rounded scale), 7
            # products per layer through 32 layers of random weights. A
            # wrong kernel errs by the logits' own size: 25% of the largest.
            check(err <= 0.25 * scale, f"llama-3-8b {mode} S={S}: logits differ by {err} "
                                       f"(max {scale})")
            check(routed == (0 if 2 * S <= 256 else 7 * cfg.num_layers),
                  f"llama-3-8b {mode} S={S}: {routed} dequant-route products")
            out.setdefault("rows", []).append(row)
            del ks, vs, rks, rvs
        # The same weights with f32 activations: the two routes then differ
        # by f32 rounding only, through all 32 layers.
        toks, lens = prompts[128]
        q32 = _f32_activations(qp)
        logits = llama.prefill(cfg32, q32, toks, lens)[0]
        with _dequant_route():
            ref = llama.prefill(cfg32, q32, toks, lens)[0]
        err, scale = (logits - ref).abs().max().item(), ref.abs().max().item()
        top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"[model llama-3-8b {mode} f32 activations] kernels vs dequant route, S=128: "
            f"logits max_abs_err={err:.3e} (max |logit| {scale:.3f}), top-1 agreement={top1:.2f}")
        check(err <= 1e-3 * scale and top1 == 1.0,
              f"llama-3-8b {mode} f32 activations: logits differ by {err} (max {scale})")
        out.setdefault("rows", []).append(dict(mode=mode, S=128, activations="float32",
                                               max_abs_err=err, max_abs_logit=scale))
        del q32, logits, ref
        out[mode] = qp
    del params, bf16_top1
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 5. engine, 6. paged engine
# --------------------------------------------------------------------------- #

def _serve_prompts(plens: list[int]) -> list[list[int]]:
    """The prompts `_serve` submits: random ids from a fixed seed."""
    gen = torch.Generator().manual_seed(3)
    return [torch.randint(0, 256, (n,), generator=gen).tolist() for n in plens]


def _zero_counts() -> None:
    """Every kernel launch counter to 0 (just before a main path's run)."""
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops import quant_matmul
    from localai_tpu_torch.ops.flash import flash_prefill_attention
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv_group
    from localai_tpu_torch.ops.paged_flash import paged_partials_rows

    flash_prefill_attention.launches = 0
    paged_partials_rows.launches = paged_partials_rows.latent_launches = 0
    quant_matmul.qmm.launches = quant_matmul.qunembed.launches = 0
    quant_matmul.qmm.launches_q = quant_matmul.qmm.launches_gq = 0
    quant_matmul.qmm.launches_g4 = 0
    quant_matmul.qmm_moe.launches = quant.moe_matmul.dequant_calls = 0
    quant.matmul.dequant_calls = quant.unembed_matmul.dequant_calls = 0
    lora_bgmv_group.launches = 0


def _read_counts() -> dict:
    """The kernel launch counters (just after a main path's run)."""
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops import quant_matmul
    from localai_tpu_torch.ops.flash import flash_prefill_attention
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv_group
    from localai_tpu_torch.ops.paged_flash import paged_partials_rows

    return {"flash_prefill": flash_prefill_attention.launches,
            "paged_attention": paged_partials_rows.launches,
            # B2's latent form (MLA: one kv head, D = 576 or 48).
            "paged_attention_latent": paged_partials_rows.latent_launches,
            "quant_matmul": quant_matmul.qmm.launches,
            # B3's 2-D launches by weight form: flat int8, grouped int8, int4.
            "quant_matmul_q": quant_matmul.qmm.launches_q,
            "quant_matmul_gq": quant_matmul.qmm.launches_gq,
            "quant_matmul_g4": quant_matmul.qmm.launches_g4,
            "quant_matmul_moe": quant_matmul.qmm_moe.launches,
            "quant_unembed": quant_matmul.qunembed.launches,
            "matmul_dequant_calls": quant.matmul.dequant_calls,
            "moe_dequant_calls": quant.moe_matmul.dequant_calls,
            "unembed_dequant_calls": quant.unembed_matmul.dequant_calls,
            "lora_bgmv": lora_bgmv_group.launches}


def _serve(eng, plens: list[int], max_new: int = 64, adapters=None,
           keep_ids: bool = False, prompts=None, stop: bool = True) -> dict:
    """Submit one request per prompt length (half greedy, half seeded top-p;
    request i with the runtime LoRA adapter adapters[i], if given) and
    stream them all; the kernel counters go to 0 just before the run and
    are read just after it. With keep_ids the result carries every
    request's token ids. `prompts`, if given, replaces the random prompts
    of `plens`; with stop=False the engine keeps running for another run."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops import quant_matmul

    reqs = []
    for i, ids in enumerate(prompts or _serve_prompts(plens)):
        sampled = i % 2 == 1
        reqs.append(GenRequest(prompt_ids=ids, max_new_tokens=max_new, ignore_eos=True,
                               temperature=0.8 if sampled else 0.0,
                               top_p=0.9 if sampled else 1.0, seed=100 + i,
                               adapter=adapters[i] if adapters else None))
    results: list = [None] * len(reqs)

    def consume(i, handle, t_submit):
        first, evs = None, []
        for ev in handle:
            if ev.kind == "token" and first is None:
                first = time.monotonic() - t_submit
            evs.append(ev)
        results[i] = (first, evs)

    # Rows of every quantized product the kernels did not take (an expert
    # product's rows counted without its expert axis).
    dequant_rows = []
    dispatch, dispatch_moe = quant_matmul.dispatch_matmul, quant_matmul.dispatch_moe_mm

    def recording(x, w):
        y = dispatch(x, w)
        if y is None:
            dequant_rows.append((quant_matmul._rows(x), x.is_floating_point()))
        return y

    def recording_moe(x, w, sub):
        y = dispatch_moe(x, w, sub)
        if y is None:
            tail = 2 if sub == quant_matmul.MOE_PER_EXPERT else 1
            dequant_rows.append((quant_matmul._rows(x, tail), x.is_floating_point()))
        return y

    # The main path's run: counts go to 0 just before, are read just after.
    _zero_counts()
    # Engine counters are read as differences over this run.
    m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
    t0 = time.monotonic()
    threads = []
    with swapped(quant_matmul, "dispatch_matmul", recording), \
            swapped(quant_matmul, "dispatch_moe_mm", recording_moe):
        for i, r in enumerate(reqs):
            h = eng.submit(r)
            th = threading.Thread(target=consume, args=(i, h, time.monotonic()))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
    wall = time.monotonic() - t0
    launches = _read_counts()
    metrics = eng.metrics()
    refs = [int(r) for r in eng._adapter_refs]
    if stop:
        eng.stop()
    check(all(not th.is_alive() for th in threads), "engine: a request never finished")
    completion, ttfts = 0, []
    for i, (first, evs) in enumerate(results):
        done = evs[-1]
        ntok = sum(1 for e in evs if e.kind == "token")
        check(done.kind == "done", f"request {i} ended with {done.kind}: {done.error}")
        check(sum(e.kind in ("done", "error") for e in evs) == 1,
              f"request {i}: more than one terminal event")
        check(ntok == done.completion_tokens == max_new,
              f"request {i}: {ntok} token events, {done.completion_tokens} completion tokens")
        completion += done.completion_tokens
        ttfts.append(first)
    def delta(k):
        return int(metrics[k] - m0[k])

    out = dict(requests=len(reqs), completion_tokens=completion, wall_s=wall,
               ttft_ms_p50=statistics.median(ttfts) * 1e3, ttft_ms_max=max(ttfts) * 1e3,
               decode_tok_s=(eng._decode_tokens - tok0) / (eng._decode_time - dt0),
               # Host wall time of the decode blocks, per decode step.
               decode_ms_per_step=(eng._decode_time - dt0) * 1e3
               / max(delta("decode_steps"), 1),
               e2e_tok_s=completion / wall,
               admissions=delta("admissions"),
               decode_blocks=delta("decode_blocks"),
               decode_steps=delta("decode_steps"),
               decode_graphs=int(metrics["decode_graphs"]),
               decode_graph_captures=delta("decode_graph_captures"),
               decode_graph_replays=delta("decode_graph_replays"),
               prefill_chunks=delta("prefill_chunks"),
               prefill_chunks_interleaved=delta("prefill_chunks_interleaved"),
               chunked_admits=delta("chunked_admits"),
               kv_pages_peak=int(metrics["kv_pages_peak"]),
               kv_preemptions=delta("kv_preemptions"),
               prefix_hits=delta("prefix_hits"),
               weight_bytes=int(metrics["weight_bytes"]),
               dequant_rows_min=min((r for r, _f in dequant_rows), default=None),
               dequant_small_float_calls=sum(f and r <= 256 for r, f in dequant_rows),
               adapter_refs=refs,
               adapter_metrics={k: v for k, v in metrics.items() if k.startswith("adapter")},
               launches=launches)
    if keep_ids:
        out["ids"] = [[e.token_id for e in evs if e.kind == "token"] for _f, evs in results]
    return out


def _check_graphs(label: str, out: dict) -> None:
    """Every decode block of the run went through a CUDA graph: captured at
    its shape's first block (which runs the body eagerly first) and
    replayed from then on."""
    blocks = out["decode_blocks"]
    graphs = out["decode_graph_captures"] + out["decode_graph_replays"]
    check(blocks > 0 and graphs == blocks,
          f"{label}: {blocks} decode blocks, {out['decode_graph_captures']} captures + "
          f"{out['decode_graph_replays']} replays")


def phase_engine(cfg, params) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(max_slots=8, max_seq=2048))
    out = _serve(eng, [20, 100, 300, 700, 1500, 20, 100, 300, 700, 1500])
    L, n = cfg.num_layers, out["launches"]
    check(n["flash_prefill"] == L * out["admissions"] and n["flash_prefill"] > 0,
          f"flash kernel launches {n['flash_prefill']} != {L} layers x "
          f"{out['admissions']} admissions")
    check(n["paged_attention"] == 0, "the dense engine launched the paged kernel")
    _check_graphs("dense engine", out)
    log(f"[engine llama-3.2-1b dense, {ONEB_LAYERS} layers] " + json.dumps(out))
    return out


# 16-step blocks keep each short request decoding across several blocks, so
# chunks run between decode blocks; prompts over 512 tokens chunk.
PAGED_ENGINE = dict(max_slots=8, max_seq=4096, kv_pages=256, kv_page_size=128,
                    prefill_chunk=512, block_sizes=(16, 4, 1))
PAGED_PROMPTS = [20, 100, 300, 700, 1500, 3000, 20, 100, 300, 3500]


def phase_paged_engine(cfg, params, small, p_small) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(**PAGED_ENGINE))
    out = _serve(eng, PAGED_PROMPTS)
    L, n = cfg.num_layers, out["launches"]
    check(n["paged_attention"] == L * (out["decode_steps"] + out["prefill_chunks"])
          and n["paged_attention"] > 0,
          f"paged kernel launches {n['paged_attention']} != {L} layers x "
          f"({out['decode_steps']} decode steps + {out['prefill_chunks']} chunks)")
    check(n["flash_prefill"] == L * out["admissions"] and n["flash_prefill"] > 0,
          f"flash kernel launches {n['flash_prefill']} != {L} layers x "
          f"{out['admissions']} single-shot admissions")
    check(out["chunked_admits"] == 4 and out["prefill_chunks"] == 2 + 3 + 6 + 7,
          f"chunked admissions {out['chunked_admits']}, chunks {out['prefill_chunks']}")
    check(out["prefill_chunks_interleaved"] > 0, "no prefill chunk ran between decode blocks")
    _check_graphs("paged engine", out)
    log(f"[engine llama-3.2-1b paged, {ONEB_LAYERS} layers] " + json.dumps(out))

    # The small f32 model: paged + chunked engine against the dense engine.
    texts = {}
    for name, kw in (("dense", {}), ("paged", dict(kv_pages=16, kv_page_size=64,
                                                   prefill_chunk=64))):
        e = Engine(small, p_small, ByteTokenizer(small.vocab_size), device="cuda",
                   engine_cfg=EngineConfig(max_slots=2, max_seq=256, block_sizes=(8,), **kw))
        try:
            hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                      max_new_tokens=24, ignore_eos=True))
                  for n_, m in ((150, 7), (3, 1), (70, 3), (200, 11))]
            texts[name] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
        finally:
            e.stop()
    log(f"[engine tiny-d64 f32] paged+chunked greedy ids equal dense: "
        f"{texts['paged'] == texts['dense']}")
    check(texts["paged"] == texts["dense"], "small model: paged engine ids differ from dense")
    return out



def _check_quant_launches(label: str, L: int, out: dict, chunks=(4, 2 + 3 + 6 + 7),
                          experts: int = 0) -> None:
    """The launch identities of a quantized paged engine run; `chunks` is
    the run's (chunked admissions, prefill chunks), `experts` the model's
    experts a layer (0: a dense MLP)."""
    n = out["launches"]
    passes = out["admissions"] + out["prefill_chunks"]
    b3 = n["quant_matmul"] + n["quant_matmul_moe"]
    check(n["quant_matmul"] > 0 and b3 + n["matmul_dequant_calls"] + n["moe_dequant_calls"]
          == 7 * L * (out["decode_steps"] + passes),
          f"{label}: B3 launches {b3} + dequant-route calls {n['matmul_dequant_calls']} + "
          f"{n['moe_dequant_calls']} != 7 x {L} layers x ({out['decode_steps']} decode "
          f"steps + {passes} prefill passes)")
    # An MoE model's three expert projections a layer (every pass), a dense
    # model's none.
    moe = n["quant_matmul_moe"] + n["moe_dequant_calls"]
    check(moe == (3 * L * (out["decode_steps"] + passes) if experts else 0)
          and (n["quant_matmul_moe"] > 0) == bool(experts),
          f"{label}: {n['quant_matmul_moe']} expert-form launches + {n['moe_dequant_calls']} "
          f"dequant-route expert products for {L} layers x ({out['decode_steps']} decode "
          f"steps + {passes} passes), experts={experts}")
    check(out["dequant_small_float_calls"] == 0,
          f"{label}: {out['dequant_small_float_calls']} dequant-route calls at <= 256 rows")
    check(n["quant_unembed"] == out["decode_steps"] + out["admissions"] + out["chunked_admits"]
          and n["unembed_dequant_calls"] == 0,
          f"{label}: B4 launches {n['quant_unembed']} != {out['decode_steps']} decode steps + "
          f"{out['admissions'] + out['chunked_admits']} passes with logits")
    check(n["paged_attention"] == L * (out["decode_steps"] + out["prefill_chunks"]),
          f"{label}: B2 launches {n['paged_attention']} != {L} x ({out['decode_steps']} + "
          f"{out['prefill_chunks']})")
    check(n["flash_prefill"] == L * out["admissions"] and n["flash_prefill"] > 0,
          f"{label}: B1 launches {n['flash_prefill']} != {L} x {out['admissions']}")
    check((out["chunked_admits"], out["prefill_chunks"]) == tuple(chunks),
          f"{label}: chunked admissions {out['chunked_admits']}, chunks {out['prefill_chunks']}")


def phase_quant_engines(model: dict, small, p_small, p_small_cpu) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    runs = {}
    for label, mode, kw in (("int8_engine", "int8", {}),
                            ("int4_fp8_engine", "int4", dict(kv_cache_dtype="fp8",
                                                             kv_scale=2.0))):
        cfg, params = _first_layers(model["cfg"], model[mode], QUANT_ENGINE_LAYERS)
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE, **kw))
        out = _serve(eng, PAGED_PROMPTS)
        del eng
        log(f"[engine llama-3-8b {label}] " + json.dumps(out))
        _check_quant_launches(label, cfg.num_layers, out)
        _check_graphs(label, out)
        runs[label] = out
    torch.cuda.empty_cache()

    # The small f32 model, int4 weights on an fp8 pool with kv_scale 2:
    # kernels on the card against plain versions on the CPU.
    texts = {}
    for dev, p in (("cuda", p_small), ("cpu", p_small_cpu)):
        e = Engine(small, p, ByteTokenizer(small.vocab_size), device=dev, quantization="int4",
                   engine_cfg=EngineConfig(max_slots=2, max_seq=256, block_sizes=(8,),
                                           kv_pages=16, kv_page_size=64, prefill_chunk=64,
                                           kv_cache_dtype="fp8", kv_scale=2.0))
        try:
            hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                      max_new_tokens=24, ignore_eos=True))
                  for n_, m in ((150, 7), (3, 1), (70, 3), (200, 11))]
            texts[dev] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
        finally:
            e.stop()
    log(f"[engine tiny-d64 f32 int4 fp8] card greedy ids equal the CPU's: "
        f"{texts['cuda'] == texts['cpu']}")
    check(texts["cuda"] == texts["cpu"], "small int4 + fp8 engine: card ids differ from the CPU's")
    return runs


# --------------------------------------------------------------------------- #
# 17. long context: llama-3.2-1b serving a 130,000-token prompt
# --------------------------------------------------------------------------- #

# The reference ladder's long-context engine (bench.py:2099-2118) at
# llama-3.2-1b's max_position: two slots, pages of 128, chunks of 512,
# sink 128 + window 4096; the hierarchical + spill engine adds table pages
# of 128 entries and a 2 GiB host budget for cold pages.
LONG_ENGINE = dict(max_slots=2, max_seq=131072, kv_pages=131072 // 128 + 8, kv_page_size=128,
                   prefill_chunk=512, attention_sink=LONG_SINK, attention_window=LONG_WINDOW,
                   block_sizes=(16, 4, 1))
LONG_SPILL = dict(kv_l1_span=LONG_SPAN, kv_spill_bytes=2 << 30)
LONG_PROMPT, LONG_NEW = 130_000, 32


def phase_long_context() -> dict:
    """llama-3.2-1b at full width, 4 of its 16 layers (bf16, seeded random
    weights) serves one 130,000-token prompt and 32 greedy tokens through
    Engine.submit, first on the flat all-hot windowed engine, then on the
    hierarchical + spill one. The ids must be identical, cold pages must
    spill within the budget, and B2 must have run for every layer of every
    chunk and decode step. Prints the device ms of each chunk (from CUDA
    events around it: flat along the prompt, since each chunk walks the
    sink and the window only), the TTFT, decode tok/s and peak memory."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import llama

    gc.collect()  # what earlier phases left unreferenced goes first
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    cfg = _arch_1b()
    params = llama.init_params(cfg, seed=5, device="cuda")
    runs = {}
    for label, kw in (("flat", {}), ("hier_spill", LONG_SPILL)):
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**LONG_ENGINE, **kw))
        chunks = []
        dispatch = eng._dispatch_chunk

        def timed(st, n, with_logits=False, dispatch=dispatch, chunks=chunks):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = dispatch(st, n, with_logits)
            b.record()
            chunks.append((st["offset"], a, b))
            return out

        eng._dispatch_chunk = timed
        t0 = time.monotonic()
        eng.warmup()  # every decode-block graph captured before the request
        warm_s = time.monotonic() - t0
        chunks.clear()
        torch.cuda.synchronize()
        out = _serve(eng, [LONG_PROMPT], max_new=LONG_NEW, keep_ids=True)
        m = eng.metrics()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for _off, a, b in chunks]
        L, n = cfg.num_layers, out["launches"]
        check(n["paged_attention"] == L * (out["decode_steps"] + out["prefill_chunks"])
              and out["prefill_chunks"] == -(-LONG_PROMPT // 512) and n["flash_prefill"] == 0,
              f"long context {label}: B2 launches {n['paged_attention']} != {L} layers x "
              f"({out['decode_steps']} decode steps + {out['prefill_chunks']} chunks), "
              f"flash {n['flash_prefill']}")
        _check_graphs(f"long context {label}", out)
        tenth = max(1, len(ms) // 10)
        out.update(
            engine={**LONG_ENGINE, **kw}, prompt_tokens=LONG_PROMPT, warmup_s=warm_s,
            chunk_ms_first_tenth=statistics.mean(ms[:tenth]),
            chunk_ms_last_tenth=statistics.mean(ms[-tenth:]),
            chunk_ms_median=statistics.median(ms), chunk_ms_max=max(ms),
            chunk_ms_by_offset={str(off): round(x, 3) for (off, _a, _b), x in
                                list(zip(chunks, ms))[::32]},
            # This phase's peak: the weights, the engine's pool, graphs and
            # workspaces, and the run's transients (spill gathers included).
            peak_memory_bytes=torch.cuda.max_memory_allocated() - before,
            kv_pages_spilled=int(m["kv_pages_spilled"]),
            kv_spill_bytes_out=int(m["kv_spill_bytes_out"]),
            kv_spill_skips=int(m["kv_spill_skips"]))
        log(f"[long_context {label}] " + json.dumps({k: v for k, v in out.items() if k != "ids"}))
        runs[label] = out
        del eng, dispatch, timed  # the pool goes before the next engine's
        gc.collect()
        torch.cuda.empty_cache()
    flat, spl = runs["flat"], runs["hier_spill"]
    summary = {k: {label: r[k] for label, r in runs.items()} for k in (
        "ttft_ms_p50", "decode_tok_s", "chunk_ms_first_tenth", "chunk_ms_last_tenth",
        "chunk_ms_median", "chunk_ms_max", "peak_memory_bytes", "kv_pages_spilled",
        "kv_spill_bytes_out", "prefill_chunks", "decode_steps")}
    summary["ids_equal"] = flat["ids"] == spl["ids"]
    log(f"[long_context llama-3.2-1b, {ONEB_LAYERS} layers] " + json.dumps(summary))
    check(flat["ids"] == spl["ids"],
          "long context: the hierarchical + spill engine's ids differ from the flat engine's")
    check(flat["kv_pages_spilled"] == 0 and 0 < spl["kv_pages_spilled"]
          and spl["kv_spill_bytes_out"] <= LONG_SPILL["kv_spill_bytes"],
          f"long context: spilled pages {spl['kv_pages_spilled']} "
          f"({spl['kv_spill_bytes_out']} bytes; budget {LONG_SPILL['kv_spill_bytes']})")
    for out in runs.values():
        del out["ids"]
    return {"summary": summary, **runs}


# --------------------------------------------------------------------------- #
# 12. graphs: the decode block as a CUDA graph against its eager body
# --------------------------------------------------------------------------- #

def _graph_pool_bytes(pool) -> int | None:
    """Bytes the allocator holds in one graph memory pool (its segments in
    the allocator's snapshot), or None when the snapshot does not say."""
    total, seen = 0, False
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        seen = True
        if tuple(seg["segment_pool_id"]) == tuple(pool):
            total += seg["total_size"]
    return total if seen else None


def _first_difference(a: list, b: list, block_sizes) -> str:
    """Where two requests' ids first differ: the token, and the step inside
    the decode block that drew it when blocks run the largest size."""
    for r, (x, y) in enumerate(zip(a, b)):
        for t, (u, v) in enumerate(zip(x, y)):
            if u != v:
                where = "the admission" if t == 0 else \
                    f"decode step {(t - 1) % max(block_sizes)} of a block"
                return f"request {r} token {t} ({where}): graph {u}, eager {v}"
    return "lengths differ"


def phase_graphs(label: str, cfg, params, probe=None, prompts=None, keep_ids=False,
                 follow=None, max_new=64, **kw) -> dict:
    """The same PAGED_PROMPTS requests (half greedy, half seeded top-p)
    served twice on fresh engines: once as the engine runs them (every
    decode block a CUDA graph: warmup() captures every shape, serving
    replays), and once with the engine's graph step swapped for a direct
    call of the eager block body. Ids and kernel launch counts must be
    identical. `probe(engine)`, if given, measures the graph-mode engine
    after its run; its result is the run's "probe". `prompts` replaces the
    random prompts of PAGED_PROMPTS; with keep_ids the runs keep their ids.
    `follow`, a list of prompts, is served as a second run on the same
    engine once the first is done (its result is the run's "follow"), so
    it can hit the prefix cache the first run filled. Each request asks for
    `max_new` tokens."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    runs = {}
    for mode in ("graph", "eager"):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE, **kw))
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(swapped(eng, "_decode_block", eng._block_body))
            t0 = time.monotonic()
            eng.warmup()
            warm_s = time.monotonic() - t0
            m = eng.metrics()
            pool = None if eng._graph_pool is None else _graph_pool_bytes(eng._graph_pool)
            out = _serve(eng, PAGED_PROMPTS, max_new=max_new, keep_ids=True, prompts=prompts,
                         stop=follow is None)
            if follow is not None:
                out["follow"] = _serve(eng, [], max_new=max_new, keep_ids=True, prompts=follow)
            if probe is not None and mode == "graph":
                out["probe"] = probe(eng)
        out.update(warmup_s=warm_s, graphs=int(m["decode_graphs"]),
                   capture_s=m["decode_graph_capture_s"], graph_pool_bytes=pool)
        runs[mode] = out
        del eng
        torch.cuda.empty_cache()
    g, e = runs["graph"], runs["eager"]
    summary = {
        "graphs": g["graphs"], "capture_s": g["capture_s"], "warmup_s": g["warmup_s"],
        "eager_warmup_s": e["warmup_s"], "graph_pool_bytes": g["graph_pool_bytes"],
        "decode_tok_s": {"graph": g["decode_tok_s"], "eager": e["decode_tok_s"]},
        "decode_ms_per_step": {"graph": g["decode_ms_per_step"],
                               "eager": e["decode_ms_per_step"]},
        "decode_steps": {"graph": g["decode_steps"], "eager": e["decode_steps"]},
        "ids_equal": g["ids"] == e["ids"], "launches_equal": g["launches"] == e["launches"],
        "launches": g["launches"],
    }
    if follow is not None:
        check(g["follow"]["ids"] == e["follow"]["ids"]
              and g["follow"]["launches"] == e["follow"]["launches"],
              f"graphs {label}: the follow-up run's ids or launches differ between graph "
              f"and eager: {g['follow']['launches']} / {e['follow']['launches']}")
    log(f"[graphs {label}] " + json.dumps(summary))
    check(g["ids"] == e["ids"], f"graphs {label}: graph ids differ from the eager body's: "
                                + _first_difference(g["ids"], e["ids"],
                                                    PAGED_ENGINE["block_sizes"]))
    check(g["launches"] == e["launches"],
          f"graphs {label}: launches {g['launches']} with graphs, {e['launches']} eager")
    # Warmup captured every shape: serving only replays.
    check(g["graphs"] == 3 * len(PAGED_ENGINE["block_sizes"]) and g["decode_graph_captures"] == 0
          and g["decode_graph_replays"] == g["decode_blocks"],
          f"graphs {label}: {g['graphs']} graphs after warmup, {g['decode_graph_captures']} "
          f"captured while serving, {g['decode_graph_replays']} replays of "
          f"{g['decode_blocks']} blocks")
    check(e["graphs"] == 0 and e["decode_graph_replays"] == 0,
          f"graphs {label}: the eager run replayed graphs")
    if not keep_ids:
        for out in runs.values():
            del out["ids"]
    return {"summary": summary, **runs}


# --------------------------------------------------------------------------- #
# 9. lora kernels
# --------------------------------------------------------------------------- #

# Every LoRA target projection (in, out) of llama-3.2-1b, then llama-3-8b:
# wq / wo, wk / wv, w_gate / w_up, w_down.
LORA_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
               (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def _lora_work(ids, NA, n_in, n_out, R, elt) -> tuple[float, float]:
    """(FLOPs, bytes) of the delta on these ids: 2·R·(in + out) per row
    with an adapter; the distinct adapters' factors, x, the ids and the
    output each moved once (null rows read no factors)."""
    return _lora_group_work(ids, NA, n_in, (n_out,), R, elt)


def _lora_group_work(ids, NA, n_in, outs, R, elt) -> tuple[float, float]:
    """(FLOPs, bytes) of a group of targets that share x: each target's
    factors read once per distinct adapter, x and the ids once for the
    group, each output written once."""
    used = {int(i) for i in ids if 0 < int(i) < NA}
    active = sum(1 for i in ids if 0 < int(i) < NA)
    N = len(ids)
    flops = sum(2.0 * R * (n_in + o) * active for o in outs)
    nbytes = elt * (sum(len(used) * R * (n_in + o) for o in outs) + N * (n_in + sum(outs))) + 4 * N
    return flops, nbytes


# bf16: both sides compute in f32 (bf16 factors widen exactly) and round once
# to bf16, so they may differ by one bf16 step (2^-7 of the value) plus a
# summation-order term of 1e-4 of the largest value.
LORA_REL_BF16, LORA_REL_SUM = 2.0**-7, 1e-4


def _hold_lora_group(x, pairs, ids) -> dict:
    """One B5 launch for targets that share x against lora_delta_plain target
    by target on the same inputs: the error within the stated tolerance,
    null rows exact zeros, the launch allocating nothing but its outputs, a
    second launch bit-identical, and each row (all of them up to 9 rows,
    else four) bit-identical to a launch on it alone."""
    from localai_tpu_torch.ops import lora_matmul as lm

    allocations = torch.cuda.memory_stats()["allocation.all.allocated"]
    outs = lm.lora_bgmv_group(x, pairs, ids)
    torch.cuda.synchronize()
    # One device allocation per output and none else (a byte count would
    # depend on how the caching allocator splits its cached blocks).
    outputs_only = (torch.cuda.memory_stats()["allocation.all.allocated"] - allocations
                    == len(outs))
    host_ids = ids.tolist()
    N = len(host_ids)
    check_rows = range(N) if N <= 9 else (0, 1, N // 2, N - 1)
    alone = {n: lm.lora_bgmv_group(x[n:n + 1], pairs, ids[n:n + 1]) for n in check_rows}
    again = lm.lora_bgmv_group(x, pairs, ids)
    errs, scales, within, null_exact, independent = [], [], True, True, True
    for t, ((a, b), out) in enumerate(zip(pairs, outs)):
        want = lm.lora_delta_plain(x, a, b, ids)
        scale = want.float().abs().max().item()
        err = (out.float() - want.float()).abs()
        within = within and bool(
            (err <= LORA_REL_BF16 * want.float().abs() + LORA_REL_SUM * scale).all()
            and torch.isfinite(out).all())
        null_exact = null_exact and all(bool((out[n] == 0).all())
                                        for n, i in enumerate(host_ids) if i == 0)
        independent = independent and all(torch.equal(out[n:n + 1], alone[n][t])
                                          for n in check_rows)
        errs.append(err.max().item())
        scales.append(scale)
    repeat_equal = all(torch.equal(o, o2) for o, o2 in zip(outs, again))
    ok = within and null_exact and independent and repeat_equal and outputs_only
    return dict(shape=[N, x.shape[1], [b.shape[2] for _, b in pairs]], rank=pairs[0][0].shape[2],
                dtype=str(x.dtype).replace("torch.", ""), ids=host_ids if N <= 9 else None,
                max_abs_err=max(errs), out_max=max(scales), null_exact=null_exact,
                rows_independent=independent, repeat_equal=repeat_equal,
                allocates_outputs_only=outputs_only, ok=ok)


def _hold_lora(x, a, b, ids) -> dict:
    """`_hold_lora_group` for one target, with its shape as [N, in, out]."""
    row = _hold_lora_group(x, [(a, b)], ids)
    row["shape"] = [row["shape"][0], row["shape"][1], row["shape"][2][0]]
    return row


# The served groups of targets that share x, one launch each: llama-3.2-1b
# {wq, wk, wv} and {w_gate, w_up} at lora_http's rank 32, llama-3-8b
# {wq, wv} at lora_8b's rank 16.
LORA_GROUPS = [("1b_qkv", 2048, (2048, 512, 512), 32), ("1b_gate_up", 2048, (8192, 8192), 32),
               ("8b_qv", 4096, (4096, 1024), 16)]


def phase_lora_kernels(gen: torch.Generator) -> tuple[list[dict], list[dict]]:
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv, lora_bgmv_group, lora_delta_plain

    dt = torch.bfloat16
    cases = [(n_in, n_out, R, 9, None) for n_in, n_out in LORA_SHAPES for R in (16, 64)]
    # lora_http's decode block: rank 32 (tenants 6-7 pad the stack), 8 slots
    # over 9 stack rows, at each llama-3.2-1b target shape.
    cases += [(n_in, n_out, 32, 8, None) for n_in, n_out in LORA_SHAPES[:4]]
    cases += [(4096, 4096, 16, 1, None), (4096, 4096, 16, 256, None), (2048, 2048, 32, 9, 8)]
    rows = []
    for n_in, n_out, R, N, small_rank in cases:
        NA = 9  # 8 adapters and the null one
        a = (torch.randn(NA, n_in, R, generator=gen, device="cuda") * 0.05).to(dt)
        b = (torch.randn(NA, R, n_out, generator=gen, device="cuda") * 0.05).to(dt)
        a[0] = 0
        b[0] = 0
        if small_rank:  # a rank-8 adapter zero-padded inside the rank-32 stack
            a[1, :, small_rank:] = 0
            b[1, small_rank:] = 0
        x = torch.randn(N, n_in, generator=gen, device="cuda").to(dt)
        if N == 9:  # 8 distinct adapters and one null row
            ids = torch.tensor([1, 2, 3, 4, 0, 5, 6, 7, 8], dtype=torch.int32, device="cuda")
        elif N == 8:  # 7 tenants and one adapter-less slot
            ids = torch.tensor([8, 1, 0, 6, 3, 2, 7, 5], dtype=torch.int32, device="cuda")
        else:
            ids = (torch.arange(N, device="cuda") % NA).to(torch.int32)
            ids[0] = 1
        row = _hold_lora(x, a, b, ids)
        host_ids = ids.tolist()
        ms = cuda_time_cold_ms(lambda: lora_bgmv(x, a, b, ids), 20)
        plain_ms = cuda_time_cold_ms(lambda: lora_delta_plain(x, a, b, ids), 3)
        # For reference only (not one call computing the same function, and
        # not a route of the port): torch.bmm twice on factors gathered
        # beforehand, in the model dtype.
        idx = ids.long()
        a_sel, b_sel = a[idx], b[idx]
        x3 = x[:, None, :]
        bmm2_ms = cuda_time_cold_ms(lambda: torch.bmm(torch.bmm(x3, a_sel), b_sel), 20)
        del a_sel, b_sel
        bound_ms, bound_by = _bound(*_lora_work(host_ids, NA, n_in, n_out, R, dt.itemsize),
                                    torch.float32)
        row.update(padded_rank=small_rank, ms=ms, plain_ms=plain_ms, bmm2_gathered_ms=bmm2_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel lora_bgmv] {json.dumps(row)}")
        check(row["ok"], f"lora_bgmv disagrees with its plain version at {row}")
        rows.append(row)
        del a, b
    # A CUDA tensor B5 does not take raises (no other route serves it).
    a = torch.zeros(3, 64, 8, dtype=dt, device="cuda")
    b = torch.zeros(3, 8, 64, dtype=dt, device="cuda")
    for bad_x, bad_ids in ((torch.zeros(2, 64, dtype=torch.float16, device="cuda"),
                            torch.zeros(2, dtype=torch.int32, device="cuda")),
                           (torch.zeros(2, 64, dtype=dt, device="cuda"),
                            torch.tensor([0, 3], dtype=torch.int32))):
        try:
            lora_bgmv(bad_x, a, b, bad_ids)
        except (TypeError, ValueError) as e:
            log(f"[kernel lora_bgmv] refused as it should: {e}")
        else:
            fail("lora_bgmv took a tensor it does not support")
    # One launch per group, at the decode block of 8 slots (7 tenants and an
    # adapter-less slot), from a generator of its own so the rows above see
    # the inputs they always saw. Beside it: the same kernel launched target
    # by target, and the plain version and two bmm calls per target.
    # The timing floor: the same flushed timing of a zero_ on 8 floats, the
    # least any launch reads here (B5's rows sit a few us above it).
    z = torch.zeros(8, device="cuda")
    floor_ms = cuda_time_cold_ms(lambda: z.zero_(), 20)
    log(f"[kernel lora_bgmv] timing floor (zero_ of 8 floats): {floor_ms:.5f} ms")
    gen_group = torch.Generator(device="cuda").manual_seed(9)
    group_rows = []
    for label, n_in, outs, R in LORA_GROUPS:
        NA = 9
        pairs = []
        for n_out in outs:
            a = (torch.randn(NA, n_in, R, generator=gen_group, device="cuda") * 0.05).to(dt)
            b = (torch.randn(NA, R, n_out, generator=gen_group, device="cuda") * 0.05).to(dt)
            a[0] = 0
            b[0] = 0
            pairs.append((a, b))
        x = torch.randn(8, n_in, generator=gen_group, device="cuda").to(dt)
        ids = torch.tensor([8, 1, 0, 6, 3, 2, 7, 5], dtype=torch.int32, device="cuda")
        row = _hold_lora_group(x, pairs, ids)
        ms = cuda_time_cold_ms(lambda: lora_bgmv_group(x, pairs, ids), 20)
        per_target = [cuda_time_cold_ms(lambda a=a, b=b: lora_bgmv(x, a, b, ids), 20)
                      for a, b in pairs]
        plain_ms = cuda_time_cold_ms(
            lambda: [lora_delta_plain(x, a, b, ids) for a, b in pairs], 3)
        idx = ids.long()
        sel = [(a[idx], b[idx]) for a, b in pairs]
        x3 = x[:, None, :]
        bmm2_ms = cuda_time_cold_ms(
            lambda: [torch.bmm(torch.bmm(x3, a_sel), b_sel) for a_sel, b_sel in sel], 20)
        del sel
        bound_ms, bound_by = _bound(*_lora_group_work(ids.tolist(), NA, n_in, outs, R,
                                                      dt.itemsize), torch.float32)
        row.update(group=label, ms=ms, timing_floor_ms=floor_ms, per_target_ms=per_target,
                   per_target_ms_sum=sum(per_target), plain_ms=plain_ms,
                   bmm2_gathered_ms=bmm2_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel lora_bgmv group] {json.dumps(row)}")
        check(row["ok"], f"lora_bgmv_group disagrees with its plain version at {row}")
        group_rows.append(row)
        del pairs
    torch.cuda.empty_cache()
    return rows, group_rows


# --------------------------------------------------------------------------- #
# 10. lora http: llama-3.2-1b tenants through the port's HTTP server
# --------------------------------------------------------------------------- #

LORA_BASE_YAML = {"name": "llama-1b", "model": ONEB_PRESET, "context_size": 4096,
                  "max_slots": 8, "kv_pages": 256, "kv_page_size": 128,
                  "prefill_chunk": 512, "max_tokens": 64,
                  # Every id decodes to one printable character, so a random
                  # model's stream carries content (a byte tokenizer would
                  # decode ids >= 256 to nothing).
                  "tokenizer": "synthetic-bytes"}


def _write_models_dir(root: str, tenants: bool) -> None:
    """The base YAML and, with `tenants`, 8 virtual models over it whose
    PEFT adapters are written from a numpy seed: tenants 0-5 are the JAX
    bench's LoRA row (rank 16 on q_proj / v_proj, lora_alpha = r), tenants
    6-7 rank 32 on all seven projections. Factors are normal · 0.04, so a
    tenant's delta is a sizeable share of the base product."""
    import yaml

    from localai_tpu_torch.engine.weights import random_lora_adapter
    from localai_tpu_torch.models import get_arch

    with open(f"{root}/llama-1b.yaml", "w") as f:
        yaml.safe_dump(LORA_BASE_YAML, f)
    if not tenants:
        return
    cfg = get_arch(LORA_BASE_YAML["model"])
    every = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    for t in range(8):
        r, targets = (16, ("wq", "wv")) if t < 6 else (32, every)
        random_lora_adapter(cfg, f"{root}/adapters/t{t}", r, r, targets, seed=t, scale=0.04)
        with open(f"{root}/tenant{t}.yaml", "w") as f:
            yaml.safe_dump({"name": f"tenant{t}", "base_model": "llama-1b",
                            "adapter": f"adapters/t{t}", "max_tokens": 64}, f)


def _http(base: str, path: str, payload: dict, t_submit: float,
          stamps: list | None = None) -> dict:
    """POST one request; for a stream, read the SSE frames as they come
    (each frame's arrival time appended to `stamps` when given). Returns
    status, the parsed body or the frames, and the client's TTFT."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            if not payload.get("stream"):
                return {"status": r.status, "body": json.loads(r.read())}
            frames, ttft = [], None
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                frames.append(line[6:])
                if stamps is not None:
                    stamps.append(time.monotonic())
                if ttft is None and line[6:] != "[DONE]":
                    c = json.loads(line[6:])["choices"][0]
                    if c.get("text") or (c.get("delta") or {}).get("content"):
                        ttft = time.monotonic() - t_submit
            return {"status": r.status, "frames": frames, "ttft": ttft}
    except urllib.error.HTTPError as e:
        return {"status": e.code, "body": e.read().decode()}


# New tokens a lora_http request: one 16-step block (64 until phase 25 joined:
# a 64-step block's graph capture on each server cost more than the run had).
LORA_NEW = 16


def _lora_requests() -> list[tuple[str, str, dict]]:
    """The measured batch: one request per tenant and 4 to the base, chat
    and completions, half streamed, half greedy (the rest seeded top-p 0.9
    at temperature 0.8), prompts of 20-1500 tokens (the byte tokenizer: one
    token per character), LORA_NEW new tokens each. Request 8 repeats request
    0's greedy prompt on the base."""
    import random

    rnd = random.Random(7)
    lens = [20, 100, 300, 700, 1500, 20, 100, 300, 20, 700, 1500, 300]
    out = []
    for i, n in enumerate(lens):
        model = f"tenant{i}" if i < 8 else "llama-1b"
        text = "".join(rnd.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(n))
        greedy = i % 2 == 0
        body = {"model": model, "max_tokens": LORA_NEW, "ignore_eos": True,
                "stream": i % 4 in (1, 2),
                "temperature": 0.0 if greedy else 0.8, "top_p": 1.0 if greedy else 0.9,
                "seed": 100 + i}
        chat = i % 3 != 2
        if chat:
            body["messages"] = [{"role": "user", "content": text}]
        else:
            body["prompt"] = text
        out.append(("/v1/chat/completions" if chat else "/v1/completions", model, body))
    path0, _m, body0 = out[0]
    out[8] = (path0, "llama-1b", {**body0, "model": "llama-1b"})
    return out


def _http_batch(base: str, reqs) -> tuple[list[dict], float]:
    results: list = [None] * len(reqs)

    def run(i, path, body):
        results[i] = _http(base, path, body, time.monotonic())

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i, path, body))
               for i, (path, _m, body) in enumerate(reqs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    check(all(not th.is_alive() for th in threads), "lora_http: a request never finished")
    return results, time.monotonic() - t0


def _check_http_results(label: str, reqs, results,
                        n_tokens: int = 64) -> tuple[list[str], list[float]]:
    """Every response 200, every stream ends in [DONE], completion tokens =
    the tokens streamed (n_tokens). Returns each request's text and the
    streams' TTFTs."""
    texts, ttfts = [], []
    for i, ((_path, _model, body), res) in enumerate(zip(reqs, results)):
        check(res["status"] == 200, f"{label}: request {i} got HTTP {res['status']}: "
                                    f"{res.get('body')}")
        if body["stream"]:
            check(res["frames"][-1] == "[DONE]", f"{label}: stream {i} did not end in [DONE]")
            chunks = [json.loads(f) for f in res["frames"][:-1]]
            check(not any("error" in c for c in chunks), f"{label}: stream {i} errored")
            toks = [c["choices"][0] for c in chunks if c["choices"][0]["finish_reason"] is None
                    and ("text" in c["choices"][0] or "content" in c["choices"][0]["delta"])]
            if "messages" in body:  # the role chunk carries no token
                toks = toks[1:]
            usage = chunks[-1]["usage"]
            text = "".join(c.get("text") or c.get("delta", {}).get("content", "") for c in toks)
            ttfts.append(res["ttft"])
            check(usage["completion_tokens"] == len(toks) == n_tokens,
                  f"{label}: stream {i}: {len(toks)} token chunks, usage {usage}")
        else:
            c = res["body"]["choices"][0]
            text = c["message"]["content"] if "message" in c else c["text"]
            check(res["body"]["usage"]["completion_tokens"] == n_tokens,
                  f"{label}: request {i}: usage {res['body']['usage']}")
        texts.append(text)
    return texts, ttfts


def _start_server(root: str, audio: bool = False):
    """The port's server over the models dir `root` in a thread: the OpenAI
    layer, and with `audio` the audio and realtime layers."""
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.audio_api import AudioApi
    from localai_tpu_torch.server.realtime_api import RealtimeApi

    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=root)
    manager = ModelManager(app, device="cuda")
    router = Router()
    oai = OpenAIApi(manager)
    oai.register(router)
    rt = None
    if audio:
        AudioApi(manager, oai).register(router)
        rt = RealtimeApi(manager, oai)
        rt.register(router)
    server = create_server(app, router)
    server.realtime = rt  # its per-append VAD record (realtime_api.RealtimeApi.vad_ms)
    threading.Thread(target=server.serve_forever, daemon=True, name="http").start()
    return manager, server, f"http://127.0.0.1:{server.server_address[1]}"


def _hold_served_lora(eng) -> list[dict]:
    """B5 against its plain version on the served engine's own stacks, at
    the first and last layer of every key, with the decode block's shape:
    one row per slot, ids in the stack's rows (every resident tenant, then
    a block with an adapter-less slot riding the null row). x stands for
    the layer's activations (normal, bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    S, NA = eng.ecfg.max_slots, eng._lora_tree["wq"]["a"].shape[1]
    blocks = [torch.arange(1, S + 1) % NA, torch.arange(S) % NA]
    rows = []
    for key, ent in sorted(eng._lora_tree.items()):
        for li in (0, eng.cfg.num_layers - 1):
            a, b = ent["a"][li], ent["b"][li]
            for ids in blocks:
                x = torch.randn(S, a.shape[1], generator=gen, device="cuda").to(a.dtype)
                row = _hold_lora(x, a, b, ids.to(device="cuda", dtype=torch.int32))
                row.update(key=key, layer=li)
                check(row["ok"], f"lora_http: B5 on the served stacks disagrees: {row}")
                rows.append(row)
    # The two groups the decode step launches as one: q / k / v, gate / up.
    tree = eng._lora_tree
    for keys in (("wq", "wk", "wv"), ("w_gate", "w_up")):
        for li in (0, eng.cfg.num_layers - 1):
            pairs = [(tree[k]["a"][li], tree[k]["b"][li]) for k in keys]
            for ids in blocks:
                x = torch.randn(S, pairs[0][0].shape[1], generator=gen,
                                device="cuda").to(pairs[0][0].dtype)
                row = _hold_lora_group(x, pairs, ids.to(device="cuda", dtype=torch.int32))
                row.update(key="+".join(keys), layer=li)
                check(row["ok"], f"lora_http: B5 on the served group disagrees: {row}")
                rows.append(row)
    worst = max(rows, key=lambda r: r["max_abs_err"] / max(r["out_max"], 1e-30))
    log(f"[lora_http served stacks] B5 vs plain on {len(rows)} (key, layer, ids) cases, "
        f"all ok; worst relative: {json.dumps(worst)}")
    return rows


def phase_lora_http() -> dict:
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv_group

    reqs = _lora_requests()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        _write_models_dir(root, tenants=True)
        manager, server, base = _start_server(root)
        try:
            # Warm pass: one short request per tenant, so every tenant is
            # promoted and the stacks hold all seven keys at rank 32.
            warm = [("/v1/completions", f"tenant{t}",
                     {"model": f"tenant{t}", "prompt": "warm up", "max_tokens": 4,
                      "temperature": 0.0}) for t in range(8)]
            results, _ = _http_batch(base, warm)
            check(all(r["status"] == 200 for r in results), f"lora_http warm pass: {results}")
            eng = manager.peek("llama-1b").engine
            stacks = {k: list(v["a"].shape) for k, v in eng._lora_tree.items()}
            check(len(stacks) == 7 and all(s[1] == 9 and s[3] == 32 for s in stacks.values()),
                  f"lora_http: stacks after the warm pass {stacks}")
            # The measured batch: counters to 0 just before, read just after.
            m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
            lora_bgmv_group.launches = 0
            results, wall = _http_batch(base, reqs)
            launches = lora_bgmv_group.launches
            m1 = eng.metrics()
            texts, ttfts = _check_http_results("lora_http", reqs, results, n_tokens=LORA_NEW)
            steps = int(m1["decode_steps"] - m0["decode_steps"])
            L = eng.cfg.num_layers
            # Admissions run no B5: their x is [B, S, D] (3-D), which takes
            # the gather form; prefill chunks carry no LoRA operand. Every
            # decode step runs the delta for all 8 slots (adapter-less and
            # idle slots ride id 0) on the 7 keys of every layer in 4
            # launches: {wq, wk, wv}, wo, {w_gate, w_up}, w_down.
            check(launches == steps * L * 4 and launches > 0,
                  f"lora_http: {launches} B5 launches != {steps} decode steps x {L} layers x 4")
            check(texts[0] != texts[8], "lora_http: tenant0's greedy output equals the base's")
            _check_graphs("lora_http", {k: int(m1[k] - m0[k]) for k in (
                "decode_blocks", "decode_graph_captures", "decode_graph_replays")})
            refs = [int(r) for r in eng._adapter_refs]
            check(not any(refs), f"lora_http: adapter pins left at the end: {refs}")
            dt_s = eng._decode_time - dt0
            out["tenants"] = dict(
                requests=len(reqs), wall_s=wall, ttft_ms_p50=statistics.median(ttfts) * 1e3,
                ttft_ms_max=max(ttfts) * 1e3, decode_tok_s=(eng._decode_tokens - tok0) / dt_s,
                decode_ms_per_step=dt_s / steps * 1e3, e2e_tok_s=LORA_NEW * len(reqs) / wall,
                decode_steps=steps, admissions=int(m1["admissions"] - m0["admissions"]),
                prefill_chunks=int(m1["prefill_chunks"] - m0["prefill_chunks"]),
                lora_bgmv_launches=launches, adapter_refs=refs,
                adapter_metrics={k: v for k, v in m1.items() if k.startswith("adapter")},
                stacks=stacks)
            log("[lora_http llama-3.2-1b 8 tenants] " + json.dumps(out["tenants"]))
            out["kernel_rows"] = _hold_served_lora(eng)
        finally:
            server.shutdown()
            manager.shutdown()
    # The same 12 requests, all to a fresh base with no tenants registered.
    base_reqs = [(p, "llama-1b", {**b, "model": "llama-1b"}) for p, _m, b in reqs]
    with tempfile.TemporaryDirectory() as root:
        _write_models_dir(root, tenants=False)
        manager, server, base = _start_server(root)
        try:
            _http_batch(base, [("/v1/completions", "llama-1b",
                                {"model": "llama-1b", "prompt": "warm up", "max_tokens": 4})])
            eng = manager.peek("llama-1b").engine
            m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
            lora_bgmv_group.launches = 0
            results, wall = _http_batch(base, base_reqs)
            _texts, ttfts = _check_http_results("lora_http base", base_reqs, results,
                                                n_tokens=LORA_NEW)
            check(lora_bgmv_group.launches == 0 and eng._lora_tree is None,
                  "lora_http base: the tenant-less base ran the LoRA kernel")
            m1 = eng.metrics()
            steps = int(m1["decode_steps"] - m0["decode_steps"])
            dt_s = eng._decode_time - dt0
            out["base"] = dict(requests=len(base_reqs), wall_s=wall,
                               ttft_ms_p50=statistics.median(ttfts) * 1e3,
                               ttft_ms_max=max(ttfts) * 1e3,
                               decode_tok_s=(eng._decode_tokens - tok0) / dt_s,
                               decode_ms_per_step=dt_s / steps * 1e3,
                               e2e_tok_s=LORA_NEW * len(base_reqs) / wall, decode_steps=steps)
        finally:
            server.shutdown()
            manager.shutdown()
    # Two host-clock readings, neither the kernel's cost alone. The tok/s
    # ratio (the JAX bench's lora_multi_vs_base) depends on scheduling:
    # adapter requests admit alone, so the tenant run decodes at other slot
    # occupancies and takes other step counts than the base. The ms per
    # decode step compares like with like (a step costs about the same at
    # any occupancy) but includes the host's share of each step;
    # profile_engine.py --lora gives the device time per step.
    out["lora_multi_vs_base_tok_s_scheduling_dependent"] = (
        out["tenants"]["decode_tok_s"] / out["base"]["decode_tok_s"])
    out["lora_step_ms_vs_base"] = (out["tenants"]["decode_ms_per_step"]
                                   / out["base"]["decode_ms_per_step"])
    log("[lora_http llama-3.2-1b base, no tenants] " + json.dumps(out["base"])
        + " lora_multi_vs_base (tok/s, scheduling-dependent)="
        + f"{out['lora_multi_vs_base_tok_s_scheduling_dependent']:.3f}"
        + f" decode ms/step tenants vs base={out['lora_step_ms_vs_base']:.3f}")
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 11. lora on llama-3-8b int8, and the small model card vs CPU
# --------------------------------------------------------------------------- #

def phase_lora_8b(qmodel: dict, small, p_small, p_small_cpu) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine.weights import random_lora_adapter

    cfg, params = _first_layers(qmodel["cfg"], qmodel["int8"], QUANT_ENGINE_LAYERS)
    L = cfg.num_layers
    with tempfile.TemporaryDirectory() as root:
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE))
        for t in range(4):  # rank 16 on q / v / o / down: B5 at 14336 -> 4096
            eng.register_adapter(f"t{t}", random_lora_adapter(
                cfg, f"{root}/t{t}", 16, 16, ("wq", "wv", "wo", "w_down"), seed=10 + t))
        for t in range(4):  # warm pass: every tenant promoted before the run
            _text, ev = eng.generate([1, 2, 3], max_new_tokens=2, adapter=f"t{t}")
            check(ev.kind == "done", f"lora_8b warm pass: {ev}")
        # Tenants admit single-shot (1500 tokens: the dequant route);
        # adapter-less requests of 700 and 3000 tokens chunk.
        plens = [20, 300, 700, 1500, 20, 100, 700, 3000]
        out = _serve(eng, plens, adapters=["t0", "t1", "t2", "t3", None, None, None, None])
        del eng
    log(f"[lora_8b llama-3-8b int8, {L} layers, 4 tenants] " + json.dumps(out))
    _check_quant_launches("lora_8b", L, out, chunks=(2, 2 + 6))
    _check_graphs("lora_8b", out)
    n = out["launches"]
    # q / v share x (one launch), o and down one each: 3 launches a layer.
    check(n["lora_bgmv"] == out["decode_steps"] * L * 3 and n["lora_bgmv"] > 0,
          f"lora_8b: B5 launches {n['lora_bgmv']} != {out['decode_steps']} decode steps x "
          f"{L} layers x 3 launches (q + v, o, down)")
    check(not any(out["adapter_refs"]), f"lora_8b: pins left {out['adapter_refs']}")
    torch.cuda.empty_cache()

    # The small f32 model, paged, three tenants and one null row: B5 on the
    # card against the plain version on the CPU.
    texts = {}
    with tempfile.TemporaryDirectory() as root:
        dirs = [random_lora_adapter(small, f"{root}/s{t}", 8, 16,
                                    ("wq", "wv", "wo", "w_down", "w_gate")[: 2 + t], seed=20 + t,
                                    scale=0.05) for t in range(3)]
        for dev, p in (("cuda", p_small), ("cpu", p_small_cpu)):
            e = Engine(small, p, ByteTokenizer(small.vocab_size), device=dev,
                       engine_cfg=EngineConfig(max_slots=4, max_seq=256, block_sizes=(8,),
                                               kv_pages=16, kv_page_size=64))
            try:
                for t, d in enumerate(dirs):
                    e.register_adapter(f"s{t}", d)
                hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                          max_new_tokens=24, ignore_eos=True, adapter=ad))
                      for n_, m, ad in ((150, 7, "s0"), (3, 1, None), (70, 3, "s1"),
                                        (40, 11, "s2"))]
                texts[dev] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
            finally:
                e.stop()
    log(f"[lora tiny-d64 f32 paged, 3 tenants + null] card greedy ids equal the CPU's: "
        f"{texts['cuda'] == texts['cpu']}")
    check(texts["cuda"] == texts["cpu"], "small LoRA engine: card ids differ from the CPU's")
    return out


# --------------------------------------------------------------------------- #
# 12c. speculative decoding on llama-3-8b int4 + fp8 pool
# --------------------------------------------------------------------------- #

# The JAX package's bench workload for speculation (bench.py, spec rows):
# request i repeats (i*13 + j) % 17 + 60 and carries a +24 logit bias on
# token (i*7) % 200 + 30, greedy.
SPEC_PROMPT_LEN = 128
SPEC_NEW = 64
SPEC_MODES = ("prompt_lookup", "self_draft", "draft_model")
SPEC_SELF_LAYERS = 2
# Of llama-3-8b's 32 layers the spec phase's target keeps its first 8 (16
# when the observe phase joined, 8 since phase 25 did: the run's time;
# every layer's width kept): self_draft drafts with 2 of them, the quarter
# the JAX bench's 8 of 32 are.
SPEC_LAYERS = 8
SPEC_N_DRAFT = 5
# Phases 8, 11, 12 and prefix_swap_8b serve llama-3-8b's first 8 of its 32
# layers (cut for the run's time: to 16, 8 and 12 when phase 25 joined, 11
# and prefix_swap_8b when phase 26 did; all four to 8 when phases 27-29 did;
# phase 7 runs all 32).
QUANT_ENGINE_LAYERS = 8


def _spec_requests(bs: int) -> list:
    from localai_tpu_torch.engine.engine import GenRequest

    return [GenRequest(prompt_ids=[(i * 13 + j) % 17 + 60 for j in range(SPEC_PROMPT_LEN)],
                       max_new_tokens=SPEC_NEW, ignore_eos=True,
                       logit_bias={(i * 7) % 200 + 30: 24.0})
            for i in range(bs)]


def _spec_serve(eng, bs: int) -> dict:
    """One batch of the workload through Engine.submit: the kernel counters
    go to 0 just before the run and are read just after it."""
    reqs = _spec_requests(bs)
    _zero_counts()
    m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
    t0 = time.monotonic()
    handles = [eng.submit(r) for r in reqs]
    evs = [list(h) for h in handles]
    wall = time.monotonic() - t0
    launches = _read_counts()
    m1 = eng.metrics()
    for i, e in enumerate(evs):
        check(e[-1].kind == "done" and sum(ev.kind == "token" for ev in e) == SPEC_NEW,
              f"spec request {i} ended with {e[-1].kind}: {e[-1].error}")

    def delta(k):
        return int(m1.get(k, 0) - m0.get(k, 0))

    dt = eng._decode_time - dt0
    out = dict(bs=bs, wall_s=wall, completion_tokens=bs * SPEC_NEW,
               e2e_tok_s=bs * SPEC_NEW / wall, decode_tok_s=(eng._decode_tokens - tok0) / dt,
               admissions=delta("admissions"), decode_blocks=delta("decode_blocks"),
               decode_steps=delta("decode_steps"), prefill_chunks=delta("prefill_chunks"),
               decode_graph_captures=delta("decode_graph_captures"),
               decode_graph_replays=delta("decode_graph_replays"),
               spec_dispatches=delta("spec_dispatches"), spec_rounds=delta("spec_rounds"),
               spec_tokens_accepted=delta("spec_tokens_accepted"),
               spec_tokens_drafted=delta("spec_tokens_drafted"),
               spec_draft_syncs=delta("spec_draft_syncs"),
               spec_draft_prefills=delta("spec_draft_prefills"),
               launches=launches,
               ids=[[ev.token_id for ev in e if ev.kind == "token"] for e in evs])
    scored = out["spec_tokens_drafted"] + out["spec_rounds"]
    out["spec_accept_rate"] = out["spec_tokens_accepted"] / scored if scored else 0.0
    out["tokens_per_slot_round"] = (out["spec_tokens_accepted"] / out["spec_rounds"]
                                    if out["spec_rounds"] else 0.0)
    return out


def _spec_replay_ms(eng, mode: str) -> float:
    """Device ms of one replay of a graph the warmup captured, every slot
    idle (each weight is read, the attention walks no pages): a mode's
    kb = n_draft greedy round at the serving window, or the plain engine's
    16-step greedy block over 16 (a step)."""
    B = eng.ecfg.max_slots
    eng._stage_block(np.zeros_like(eng.h_active), np.zeros((B,), np.int32),
                     np.zeros((B, SPEC_N_DRAFT), np.int64) if mode == "prompt_lookup" else None)
    if mode == "off":
        graph = eng._graph_cache[eng._block_key(16, "greedy", 0)][0]
        return cuda_time_ms(graph.replay, reps=5, warmup=1) / 16
    win = 0 if mode == "prompt_lookup" else eng._KV_WIN_MIN
    graph = eng._graph_cache[eng._spec_key(mode, SPEC_N_DRAFT, "greedy", win)][0]
    return cuda_time_ms(graph.replay, reps=5, warmup=1)


def _spec_small(small, p_small, p_small_cpu) -> dict:
    """The small f32 model's spec engines on the card against the same
    engines on the CPU, paged and dense: the pinned-bias prompt (greedy,
    under a LoRA tenant in the model-free modes, whose verify rows take
    B5), a seeded top-k request on a mildly biased repetitive prompt (the
    stochastic accept test) and two plain greedy prompts; max_seq 512, so
    the dense rounds read a 256-row window. Equal ids, and rounds on the
    card."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine.weights import random_lora_adapter
    from localai_tpu_torch.models import llama

    dcfg = dataclasses.replace(small, name="tiny-d64-draft", num_layers=1)
    d_cpu = llama.init_params(dcfg, seed=9, device="cpu")
    d_gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in d_cpu.items()}
    sampled = dict(temperature=0.8, top_k=40, seed=5)
    reqs = [([10] + [77] * 30, {77: 25.0}, {}),
            ([(j * 3) % 250 + 1 for j in range(40)] + [9] * 12, {9: 3.0}, sampled),
            ([(j * 7) % 250 + 1 for j in range(70)], {}, {}), ([3, 1, 4, 1, 5], {}, {})]
    layouts = {"paged": dict(kv_pages=16, kv_page_size=64), "dense": {}}
    out = {}
    with tempfile.TemporaryDirectory() as root:
        adir = random_lora_adapter(small, f"{root}/s0", 8, 16, ("wq", "wv", "w_down"), seed=30,
                                   scale=0.05)
        for layout, pool in layouts.items():
            for mode in SPEC_MODES:
                label = f"small spec {layout} {mode}"
                ids, runs = {}, {}
                for dev, p, dp in (("cuda", p_small, d_gpu), ("cpu", p_small_cpu, d_cpu)):
                    kw = (dict(draft_cfg=dcfg, draft_params=dp, n_draft=SPEC_N_DRAFT)
                          if mode == "draft_model" else {})
                    e = Engine(small, p, ByteTokenizer(small.vocab_size), device=dev,
                               engine_cfg=EngineConfig(max_slots=4, max_seq=512,
                                                       block_sizes=(8,), spec_mode=mode,
                                                       **pool), **kw)
                    adapter = None
                    if mode != "draft_model":
                        e.register_adapter("s0", adir)
                        adapter = "s0"
                    try:
                        if dev == "cuda":
                            _zero_counts()
                        hs = [e.submit(GenRequest(prompt_ids=pr, max_new_tokens=24,
                                                  ignore_eos=True, logit_bias=b,
                                                  adapter=adapter if i == 0 else None, **skw))
                              for i, (pr, b, skw) in enumerate(reqs)]
                        ids[dev] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
                        if dev == "cuda":
                            launches = _read_counts()
                        m = e.metrics()
                        runs[dev] = dict(spec_rounds=int(m["spec_rounds"]),
                                         spec_accept_rate=m["spec_accept_rate"])
                    finally:
                        e.stop()
                check(ids["cuda"] == ids["cpu"], f"{label}: card ids differ from the CPU's")
                check(runs["cuda"]["spec_rounds"] > 0, f"{label}: no round on the card")
                check(launches["flash_prefill"] > 0
                      and (launches["paged_attention"] > 0) == (layout == "paged"),
                      f"{label}: a kernel of the path did not run: {launches}")
                check(mode == "draft_model" or launches["lora_bgmv"] > 0,
                      f"{label}: the tenant's rows never reached B5: {launches}")
                out[f"{layout}_{mode}"] = dict(card_equals_cpu=True, **runs["cuda"],
                                               launches=launches)
    log(f"[spec tiny-d64 f32] card ids equal the CPU's, paged and dense, in every mode: "
        f"{json.dumps(out)}")
    return out


def _first_layers(cfg, params: dict, n: int):
    """cfg and params cut to their first n layers (views of the stacked
    layer tensors; embedding, final norm and head kept)."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[:n]
    return dataclasses.replace(cfg, num_layers=n), {**params, "layers": cut(params["layers"])}


def phase_spec(qmodel: dict, small, p_small, p_small_cpu) -> dict:
    """Speculative decoding on llama-3-8b int4 (full width, the first
    SPEC_LAYERS of its 32 layers) over the fp8 paged pool (PAGED_ENGINE,
    kv_scale 2): the plain engine, then
    prompt_lookup, self_draft (its first SPEC_SELF_LAYERS layers) and draft_model
    (llama-3.2-1b bf16, full width, 4 of its 16 layers, seeded random weights), each
    warmed up (every round shape captured) and then serving the pinned-bias
    workload at bs 1 and bs 8. Greedy ids must equal the plain engine's
    (or part at a near tie: _part_gap with the request's bias); every
    round is a graph replay; B2 launches = layers x (plain steps + rounds +
    chunks), B1 = layers x single-shot admissions + the draft's layers x its
    prefills; then the small f32 spec engines, card against CPU."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import llama

    cfg, params = _first_layers(qmodel["cfg"], qmodel["int4"], SPEC_LAYERS)
    L = cfg.num_layers
    dcfg = _arch_1b()
    dparams = llama.init_params(dcfg, seed=1, device="cuda")
    ecfg = dict(PAGED_ENGINE, kv_cache_dtype="fp8", kv_scale=2.0)
    out = {"runs": {}, "modes": {}}
    plain_ids = {}
    for mode in ("off",) + SPEC_MODES:
        kw = {}
        if mode == "draft_model":
            kw = dict(draft_cfg=dcfg, draft_params=dparams, n_draft=SPEC_N_DRAFT)
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**ecfg, spec_mode=mode,
                                             self_draft_layers=SPEC_SELF_LAYERS), **kw)
        try:
            t0 = time.monotonic()
            eng.warmup()
            rec = dict(warmup_s=time.monotonic() - t0,
                       graphs_after_warmup=len(eng._graph_cache))
            for bs in (1, 8):
                run = _spec_serve(eng, bs)
                ids = run.pop("ids")
                n = run["launches"]
                label = f"spec {mode} bs{bs}"
                check(run["decode_graph_captures"] == 0 and run["decode_graph_replays"]
                      == run["decode_blocks"] > 0,
                      f"{label}: {run['decode_graph_captures']} captures after warmup(), "
                      f"{run['decode_graph_replays']} replays of {run['decode_blocks']} blocks")
                # A prefix hit (bs 8's request 0 repeats bs 1's prompt) admits
                # by chunks, which walk the pool too.
                check(n["paged_attention"] == L * (run["decode_steps"] + run["spec_dispatches"]
                                                   + run["prefill_chunks"]),
                      f"{label}: B2 launches {n['paged_attention']} != {L} layers x "
                      f"({run['decode_steps']} plain steps + {run['spec_dispatches']} rounds + "
                      f"{run['prefill_chunks']} chunks)")
                check(n["flash_prefill"] == L * run["admissions"]
                      + dcfg.num_layers * run["spec_draft_prefills"],
                      f"{label}: B1 launches {n['flash_prefill']} != {L} x {run['admissions']} "
                      f"admissions + {dcfg.num_layers} x {run['spec_draft_prefills']} draft "
                      f"prefills")
                check(n["quant_matmul"] > 0 and n["quant_unembed"] > 0,
                      f"{label}: B3 / B4 did not run: {n}")
                if mode == "off":
                    plain_ids[bs] = ids
                else:
                    check(run["spec_dispatches"] > 0 and run["spec_tokens_drafted"] > 0,
                          f"{label}: no round ran")
                    parts = []
                    for i, (want, got) in enumerate(zip(plain_ids[bs], ids)):
                        if want != got:
                            r = _spec_requests(bs)[i]
                            gap = _part_gap(cfg, params, r.prompt_ids, want, got,
                                            {"logit_bias": r.logit_bias})
                            check(gap["gap"] <= gap["bound"],
                                  f"{label}: request {i} parts from the plain engine at {gap}")
                            parts.append(gap)
                    run["parted_from_plain"] = parts
                rec[f"bs{bs}"] = run
                out["runs"][f"spec_8b_{mode}_bs{bs}"] = run
                log(f"[spec llama-3-8b int4 fp8 {mode} bs{bs}] " + json.dumps(run))
            rec["replay_ms"] = _spec_replay_ms(eng, mode)
            rec["graphs"] = len(eng._graph_cache)
            out["modes"][mode] = rec
        finally:
            eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del dparams
    torch.cuda.empty_cache()
    step_ms = out["modes"]["off"]["replay_ms"]
    summary = {"plain": {"ms_per_step_replay": step_ms,
                         **{f"decode_tok_s_bs{bs}": out["modes"]["off"][f"bs{bs}"]["decode_tok_s"]
                            for bs in (1, 8)}}}
    for mode in SPEC_MODES:
        rec = out["modes"][mode]
        summary[mode] = dict(
            ms_per_round_replay=rec["replay_ms"], round_over_step=rec["replay_ms"] / step_ms,
            warmup_s=rec["warmup_s"], graphs=rec["graphs"],
            **{f"{k}_bs{bs}": rec[f"bs{bs}"][k] for bs in (1, 8)
               for k in ("tokens_per_slot_round", "spec_accept_rate", "decode_tok_s",
                         "spec_dispatches", "decode_graph_replays")},
            **{f"speedup_bs{bs}": rec[f"bs{bs}"]["decode_tok_s"]
               / summary["plain"][f"decode_tok_s_bs{bs}"] for bs in (1, 8)})
    out["small"] = _spec_small(small, p_small, p_small_cpu)
    out["summary"] = summary
    log("[spec summary] " + json.dumps(summary))
    return out


# --------------------------------------------------------------------------- #
# 13. moe kernels: B3's expert form at mixtral-8x7b's shapes
# --------------------------------------------------------------------------- #

# (einsum, experts, in, out): gate / up with x shared by the experts, down
# with one x row per expert.
MOE_SHAPES = [("...d,edf->...ef", 8, 4096, 14336), ("...ef,efd->...ed", 8, 14336, 4096)]
# deepseek-v2-lite's experts (E = 64: gate / up 2048 x 1408, down 1408 x
# 2048), int8 and int4, bf16 x, at a decode row, a decode block of 8 slots,
# a 6-token verify of 8 slots (48 rows) and the kernels' 256-row limit; and
# grouped int8 (a deepseek2 GGUF's experts) at 8 and 48 rows.
DEEPSEEK_MOE_SHAPES = [("...d,edf->...ef", 64, 2048, 1408), ("...ef,efd->...ed", 64, 1408, 2048)]


def phase_moe_kernels() -> list[dict]:
    """B3's expert form held as phase 3 holds B3 (`_hold_b3`) at every
    form, x dtype and row count of the mixtral path, and at
    deepseek-v2-lite's experts (DEEPSEEK_MOE_SHAPES), beside a bf16
    torch.bmm on the dequantized stack (`bf16_ms`: the matmul the quantized
    kernel has to beat) and models/quant.moe_matmul with the kernel route
    off (`dequant_ms`)."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops.quant_matmul import MOE_SHARED, qmm_moe, qmm_moe_plain, qmm_plan

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    cases = ([(sh, QMM_FORMS, (torch.bfloat16, torch.float32), (1, 8, 16, 64, 256))
              for sh in MOE_SHAPES]
             + [(sh, ("int8", "int4"), (torch.bfloat16,), (1, 8, 48, 256))
                for sh in DEEPSEEK_MOE_SHAPES]
             # A deepseek2 GGUF's experts: grouped int8 per expert (phase gguf_deepseek).
             + [(sh, ("grouped_int8",), (torch.bfloat16,), (8, 48))
                for sh in DEEPSEEK_MOE_SHAPES])
    for (sub, E, n_in, n_out), forms, dtypes, counts in cases:
        w = torch.randn(E, n_in, n_out, generator=gen, device="cuda") * 0.02
        for form in forms:
            qw = {"int8": quant.quantize_tensor, "grouped_int8": _grouped_int8,
                  "int4": quant.quantize_tensor_g4}[form](w)
            w_bf16 = quant.dequantize_tensor(qw).to(torch.bfloat16)  # [E, in, out]
            for dt in dtypes:
                for N in counts:
                    xshape = (N, n_in) if sub == MOE_SHARED else (N, E, n_in)
                    x = torch.randn(xshape, generator=gen, device="cuda").to(dt)
                    xb = x.to(torch.bfloat16)
                    xe = (xb.unsqueeze(0).expand(E, N, n_in) if sub == MOE_SHARED
                          else xb.transpose(0, 1))
                    # Every expert's payload and scales, x and the output, once.
                    flops, wbytes = _qmm_work(form, 1, n_in, n_out, 0)
                    work = (E * N * flops,
                            E * wbytes + dt.itemsize * (x.numel() + N * E * n_out))
                    plan = (qmm_plan(n_in, n_out, N, kernels.sm_count(x.device), E)._asdict()
                            if dt == torch.bfloat16 else None)
                    rows.append(_hold_b3(
                        "quant_matmul_moe", lambda v: qmm_moe(v, qw, sub),
                        lambda v: qmm_moe_plain(v, qw, sub), x, lambda: torch.bmm(xe, w_bf16),
                        lambda v: quant.moe_matmul(v, qw, sub), work, plan,
                        sub=sub, shape=[N, E, n_in, n_out], form=form))
            del qw, w_bf16
        del w
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------- #
# 14. mixtral int4, 15. mixtral int8, 16. the small MoE model card vs CPU
# --------------------------------------------------------------------------- #

def _moe_probe(eng) -> dict:
    """The graph-mode engine after its run: the device time of a decode
    step (one replay of the 16-step greedy block's graph over the staged
    controls, all slots idle: the attention walks no pages, every weight
    is still read) against the byte floor of the quantized weights it
    reads, and the wall time of two fused admissions (the kernels' route
    at 1 x 128 rows, the dequantize-then-matmul route at 8 x 512)."""
    eng._stage_block(np.zeros_like(eng.h_active))
    graph = eng._graph_cache[eng._block_key(16, "greedy", 0)][0]
    step_ms = cuda_time_ms(graph.replay, reps=5, warmup=1) / 16
    wbytes = sum(t.numel() * t.element_size() for w in
                 [*eng.params["layers"].values(), eng.params.get("lm_head")]
                 if isinstance(w, dict) for t in w.values())
    admit_ms = {}
    for m, bucket in ((1, 128), (8, 512)):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._warm_admit(m, bucket)
        admit_ms[f"{m}x{bucket}"] = (time.monotonic() - t0) * 1e3
    return dict(device_ms_per_step=step_ms, quantized_weight_bytes=wbytes,
                byte_floor_ms=wbytes / PEAK_BYTES * 1e3, admission_ms=admit_ms)


# of 32: the int4 run is cut for time (32 until the deepseek phases joined
# the run, 8 until phases 27-29 did).
MIXTRAL_INT4_LAYERS = 4


def phase_mixtral(gen: torch.Generator) -> dict:
    """mixtral-8x7b int4 at full width, MIXTRAL_INT4_LAYERS of its 32 layers
    (cut for time): the quantized random init,
    a 256-row prefill through the kernels with every MoE layer held to the
    dequantize-then-matmul route on the same input, then phase 12's
    graph-against-eager run with the MoE launch identities and the probe
    above."""
    from localai_tpu_torch.models import get_arch, llama, quant
    from localai_tpu_torch.ops.quant_matmul import qmm_moe

    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), num_layers=MIXTRAL_INT4_LAYERS)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = quant.init_params_quantized(cfg, seed=0, mode="int4", device="cuda")
    torch.cuda.synchronize()
    init = dict(init_s=time.monotonic() - t0,
                allocated_gib=torch.cuda.memory_allocated() / 2**30,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[mixtral-8x7b int4, {L} layers] random weights made int4 on the card: "
        f"{json.dumps(init)}")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda")
    lens = torch.tensor([128, 91], device="cuda")
    moe_dense, route = llama._moe_dense, llama._moe_route

    def run(record):
        """The 256-row prefill, recording each MoE layer's (params, input)
        and each router call's top-k ids."""
        layers, sels = [], []

        def dense(cfg_, lp, x):
            layers.append((lp, x))
            return moe_dense(cfg_, lp, x)

        def routing(cfg_, lp, x):
            w, sel = route(cfg_, lp, x)
            sels.append(sel)
            return w, sel

        with swapped(llama, "_moe_dense", dense), swapped(llama, "_moe_route", routing):
            logits = llama.prefill(cfg, params, toks, lens)[0]
        record.update(layers=layers, sels=sels)
        return logits

    kern, deq = {}, {}
    before = (quant.matmul.dequant_calls + quant.moe_matmul.dequant_calls, qmm_moe.launches)
    logits = run(kern)
    routed = quant.matmul.dequant_calls + quant.moe_matmul.dequant_calls - before[0]
    moe_launches = qmm_moe.launches - before[1]
    with _dequant_route():
        ref = run(deq)
    check(bool(torch.isfinite(logits).all()) and logits.shape == (2, cfg.vocab_size),
          "mixtral prefill logits not finite / wrong shape")
    check(routed == 0 and moe_launches == 3 * L,
          f"mixtral int4 prefill: {routed} dequant-route products, {moe_launches} expert launches")
    # Each MoE layer on the same input through both routes (the kernels'
    # input of the free run): the routing is then the same on both sides,
    # and the layers differ by bf16 rounding only (the dequant route rounds
    # the dequantized weights and its group sums of x to bf16).
    layer_err = []
    for lp, x in kern["layers"]:
        y = moe_dense(cfg, lp, x)
        with _dequant_route():
            y_ref = moe_dense(cfg, lp, x)
        layer_err.append((y.float() - y_ref.float()).abs().max().item()
                         / y_ref.float().abs().max().item())
    # The free runs: each route feeds its own layers. Routing is discrete,
    # so once rounding flips a token's top-2 somewhere, that token's path
    # differs from there on; the logits are recorded, not held to a bound.
    live = torch.arange(128, device="cuda")[None, :] < lens[:, None]  # [2, 128]
    flips = [((a != b).any(-1) & live).float().sum().item() / live.sum().item()
             for a, b in zip(kern["sels"], deq["sels"])]
    err, scale = (logits - ref).abs().max().item(), ref.abs().max().item()
    prefill = dict(rows=256, max_abs_err=err, max_abs_logit=scale, dequant_calls=routed,
                   expert_launches=moe_launches,
                   top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                   layer_rel_err_max=max(layer_err), layer_rel_err=layer_err,
                   first_layer_routing_differs=next((i for i, f in enumerate(flips) if f), None),
                   routing_differs_share=flips)
    log(f"[mixtral-8x7b int4] 256-row prefill, kernels vs dequant route: {json.dumps(prefill)}")
    # Every layer, same input, bf16 on both sides: 5 % of the layer's
    # largest output (phase 4's bf16 bound); a wrong kernel errs by the
    # output's own size.
    check(max(layer_err) <= 0.05, f"mixtral int4: an MoE layer's kernel route differs from "
                                  f"the dequant route by {max(layer_err)} of its largest output")
    del logits, ref, kern, deq
    runs = phase_graphs("mixtral-8x7b int4 paged", cfg, params, probe=_moe_probe)
    for mode in ("graph", "eager"):
        _check_quant_launches(f"mixtral {mode}", L, runs[mode], experts=cfg.num_experts)
    _check_graphs("mixtral graph", runs["graph"])
    probe = runs["graph"]["probe"]
    summary = dict(init=init, prefill=prefill, weight_bytes=runs["graph"]["weight_bytes"],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   b3_per_decode_step=7 * L, expert_launches_per_decode_step=3 * L, **probe,
                   decode_ms_per_step=runs["graph"]["decode_ms_per_step"],
                   decode_tok_s=runs["graph"]["decode_tok_s"],
                   ttft_ms_p50=runs["graph"]["ttft_ms_p50"])
    log(f"[mixtral-8x7b int4 paged] {json.dumps(summary)}")
    del params
    torch.cuda.empty_cache()
    return {"summary": summary, **runs}


MIXTRAL_INT8_LAYERS = 8  # of 32: the int8 run is cut for time


def phase_mixtral_int8() -> dict:
    """mixtral-8x7b int8 (the flat form) at full width, 8 of 32 layers,
    through the paged engine with phase 6's requests."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, quant

    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), num_layers=MIXTRAL_INT8_LAYERS)
    params = quant.init_params_quantized(cfg, seed=1, mode="int8", device="cuda")
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(**PAGED_ENGINE))
    out = _serve(eng, PAGED_PROMPTS)
    del eng, params
    log(f"[mixtral-8x7b int8, {cfg.num_layers} layers] " + json.dumps(out))
    _check_quant_launches("mixtral int8", cfg.num_layers, out, experts=cfg.num_experts)
    _check_graphs("mixtral int8", out)
    torch.cuda.empty_cache()
    return out


def phase_moe_small() -> dict:
    """A small f32 mixtral-family model (head_dim 64, so B1 serves it), its
    paged + chunked engine on the card against the same engine on the CPU:
    unquantized experts (the exact top-k route) and int4 (B3's expert form,
    the f32 kernel). Greedy ids must be equal."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama
    from localai_tpu_torch.ops.quant_matmul import qmm_moe

    small = dataclasses.replace(get_arch("tiny-moe"), name="tiny-moe-d64", hidden_size=256,
                                intermediate_size=512, num_heads=4, num_kv_heads=2,
                                dtype="float32")
    p_cpu = llama.init_params(small, seed=2, device="cpu")
    p_gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    out = {}
    for mode in ("", "int4"):
        texts = {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            before = qmm_moe.launches
            e = Engine(small, p, ByteTokenizer(small.vocab_size), device=dev, quantization=mode,
                       engine_cfg=EngineConfig(max_slots=2, max_seq=256, block_sizes=(8,),
                                               kv_pages=16, kv_page_size=64, prefill_chunk=64))
            try:
                hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                          max_new_tokens=24, ignore_eos=True))
                      for n_, m in ((150, 7), (3, 1), (70, 3), (200, 11))]
                texts[dev] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
            finally:
                e.stop()
            if dev == "cuda":
                out[f"{mode or 'plain'}_expert_launches"] = qmm_moe.launches - before
        equal = texts["cuda"] == texts["cpu"]
        out[f"{mode or 'plain'}_ids_equal"] = equal
        log(f"[engine tiny-moe-d64 f32 {mode or 'unquantized'}] card greedy ids equal the "
            f"CPU's: {equal}")
        check(equal, f"small MoE engine {mode or 'unquantized'}: card ids differ from the CPU's")
    check(out["plain_expert_launches"] == 0 and out["int4_expert_launches"] > 0,
          f"small MoE engine: expert-form launches {out}")
    return out


# --------------------------------------------------------------------------- #
# 18. prefix_swap: the prefix cache and the host swap tier
# --------------------------------------------------------------------------- #

# Full-width chat traffic: 8 conversations share a 1536-token system prompt,
# each turn adds a 48-200-token user message, 3 turns of 64 new tokens, turn
# n + 1 = turn n's prompt + its answer + a new message; conversations 2 and 5
# sample (top-p 0.9, temperature 0.8, seeded), the rest are greedy. Four short
# prompts (<= 400 tokens, one chunk: single-shot through B1) miss beside them.
PREFIX_SYS, PREFIX_CONVS, PREFIX_TURNS, PREFIX_NEW = 1536, 8, 3, 64
PREFIX_SEEDED = (2, 5)
PREFIX_SHORTS = [57, 180, 311, 400]
# bf16: a hit computes its tail over stored K/V where a miss chunks the
# prompt on another grid, so the f32 sums run in another order. A hit's
# first-token logits must lie within 2^-5 of the largest |logit| of the
# miss's; its ids may part from the miss's only where a plain prefill of
# the same sequence picks the hit's token, or a change of its logits within
# that same bound would (`_part_gap`): bf16 paths part at near ties, and
# later in a turn the miss drifts from the plain recomputation as much as
# the hit does.
PREFIX_LOGIT_TOL = 2.0 ** -5
# Swap at full width: 8 prompts whose last chunk buckets to 256 rows, so each
# admission reserves 11 pages of 4 MiB (10 + headroom) and 256 new tokens
# take a 12th: the 88-page pool holds every reservation and no growth, and
# auto swaps the victims' spans (<= 48 MiB, under a quarter of 256 MiB).
SWAP_ENGINE = dict(PAGED_ENGINE, kv_pages=88)
SWAP_PROMPTS = [1160, 1180, 1200, 1220, 1240, 1260, 1270, 1280]
LONG_PREFIX_ENGINE = dict(max_slots=2, max_seq=32768, kv_pages=32768 // 128 + 8,
                          kv_page_size=128, prefill_chunk=512, attention_sink=LONG_SINK,
                          attention_window=LONG_WINDOW, block_sizes=(16, 4, 1), **LONG_SPILL)


def _conversations(eng, seed: int = 11) -> dict:
    """Serve the chat traffic on `eng`: conversation 0's first turn alone
    (it stores the system prompt), then every other turn and the short
    prompts at once, each conversation's turns in order. Launch counters go
    to 0 just before and are read just after. Records each request's TTFT,
    ids, prefix match (the chunked admission's start) and first-token
    logits (by prompt)."""
    from localai_tpu_torch.engine.engine import GenRequest

    gen = torch.Generator().manual_seed(seed)
    sys_ids = torch.randint(0, 256, (PREFIX_SYS,), generator=gen).tolist()
    msgs = [[torch.randint(0, 256, (int(torch.randint(48, 201, (1,), generator=gen)),),
                           generator=gen).tolist() for _t in range(PREFIX_TURNS)]
            for _c in range(PREFIX_CONVS)]
    shorts = [torch.randint(0, 256, (n,), generator=gen).tolist() for n in PREFIX_SHORTS]
    matches, firsts = {}, {}
    chunk_start, install = eng._chunk_start, eng._install_first

    def spy_start(request, handle, hit=None):
        ok = chunk_start(request, handle, hit)
        if ok:
            matches[id(handle)] = eng._chunkings[-1]["offset"]
        return ok

    def spy_install(logits, prompt, lens, *a):
        for j in range(prompt.shape[0]):
            n = int(lens[j])
            if n > PREFIX_SYS:
                firsts[tuple(prompt[j, :n].tolist())] = logits[j].float().cpu()
        return install(logits, prompt, lens, *a)

    eng._chunk_start, eng._install_first = spy_start, spy_install
    records: list = []
    lock = threading.Lock()

    def ask(prompt, conv, turn):
        kw = (dict(temperature=0.8, top_p=0.9, seed=300 + conv) if conv in PREFIX_SEEDED
              else {})
        t0 = time.monotonic()
        h = eng.submit(GenRequest(prompt_ids=prompt, max_new_tokens=PREFIX_NEW,
                                  ignore_eos=True, **kw))
        first, ids = None, []
        for ev in h:
            if ev.kind == "token":
                first = first or time.monotonic() - t0
                ids.append(ev.token_id)
        check(ev.kind == "done" and len(ids) == PREFIX_NEW,
              f"prefix_swap: conversation {conv} turn {turn} ended with {ev.kind}")
        with lock:
            records.append(dict(conv=conv, turn=turn, prompt=prompt, ids=ids, ttft=first,
                                match=matches.get(id(h), 0), kw=kw))
        return ids

    def converse(conv, start):
        prompt = sys_ids + msgs[conv][0]
        for turn in range(PREFIX_TURNS):
            if turn:
                prompt = prompt + ids + msgs[conv][turn]
            ids = start if turn == 0 and start is not None else ask(prompt, conv, turn)

    _zero_counts()
    m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
    t0 = time.monotonic()
    first_ids = ask(sys_ids + msgs[0][0], 0, 0)
    threads = [threading.Thread(target=converse, args=(c, first_ids if c == 0 else None))
               for c in range(PREFIX_CONVS)]
    threads += [threading.Thread(target=ask, args=(p, -1, 0)) for p in shorts]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.monotonic() - t0
    launches = _read_counts()
    m = eng.metrics()
    check(all(not th.is_alive() for th in threads), "prefix_swap: a request never finished")
    eng._chunk_start, eng._install_first = chunk_start, install
    return dict(records=records, firsts=firsts, launches=launches, wall_s=wall,
                metrics={k: m[k] - m0[k] for k in m},
                decode_tok_s=(eng._decode_tokens - tok0) / (eng._decode_time - dt0))


def _part_gap(cfg, params, prompt, want, got, kw) -> dict:
    """Where `got` first parts from `want`: the choice a plain prefill of
    the prompt and the common ids makes there (the engine's sampler on its
    last logits, with the request's seed and the token's position), and the
    least change of those logits, in logit units, that turns it into
    `got`'s token (0 when it is `got`'s): greedy, the two logits' gap;
    sampled, the gap of their scores times T (logit + T x the draw's noise)
    when both lie in the top-p set, else how far the logits above `got`'s
    token must fall for it to enter the set, ln(mass before it / top_p),
    and with `got`'s token outside the sampler's 64 candidates the least
    raise of its logit that makes the sampler pick it; or, where less, the
    least lowering of the plain choice's logit that does (it leaves the
    top-p set, or its score falls below `got`'s). A `logit_bias` in kw is
    added to the logits first. The bound is PREFIX_LOGIT_TOL of the
    largest |logit|."""
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops.sampling import (SamplingParams, _filter_sorted, gumbel_noise,
                                                sample)

    p = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    seq = list(prompt) + list(want[:p])
    toks = torch.tensor([seq], dtype=torch.int64, device="cuda")
    logits = llama.prefill(cfg, params, toks, torch.tensor([len(seq)], device="cuda"))[0]
    for tok, b in (kw.get("logit_bias") or {}).items():  # the request's bias, as the engine adds it
        logits[:, int(tok)] += b
    T, top_p = kw.get("temperature", 0.0), kw.get("top_p", 1.0)
    sp = SamplingParams.make(1, temperature=T, top_p=top_p, device="cuda")
    seed = torch.tensor([kw.get("seed", 0)], device="cuda")
    pos = torch.tensor([len(seq)], device="cuda")
    a = int(sample(logits, seed, pos, sp)[0])  # the plain recomputation's choice
    logits = logits[0].float()
    b = got[p]
    gap, how = float(logits[a] - logits[b]), "logits"
    if a == b:
        gap, how = 0.0, "the plain recomputation picks it"
    elif T > 0:
        def least_move(tok: int, sign: float) -> float:
            """The least move of tok's logit (up for sign 1, down for -1)
            after which the sampler picks got's token, bisected below the
            first doubling from 1 that does; inf past 1e4."""
            def picks(d: float) -> bool:
                moved = logits.clone()
                moved[tok] += sign * d
                return int(sample(moved[None], seed, pos, sp)[0]) == b

            lo, hi = 0.0, 1.0
            while hi < 1e4 and not picks(hi):
                lo, hi = hi, hi * 2
            if not picks(hi):
                return float("inf")
            for _ in range(32):
                mid = (lo + hi) / 2
                lo, hi = (lo, mid) if picks(mid) else (mid, hi)
            return hi

        sl, si = torch.topk(logits, 64)
        kept = (_filter_sorted(sl[None], sp)[0] > -1e29).tolist()
        rank = {int(t): r for r, t in enumerate(si.tolist())}
        if b in rank and kept[rank[b]]:
            g = gumbel_noise(seed, pos, logits.shape[-1])[0]
            gap, how = float(logits[a] - logits[b] + T * (g[a] - g[b])), "scores"
        elif b in rank:
            before = float(torch.softmax(sl, dim=-1)[: rank[b]].sum())
            gap, how = float(np.log(before / top_p)), "top_p"
        else:
            gap, how = least_move(b, 1.0), "raise into the candidates"
        lower = least_move(a, -1.0)
        if lower < abs(gap):
            gap, how = lower, "lowering the plain choice"
    top2 = torch.topk(logits, 2).values
    return dict(position=p, want=want[p], got=b, plain=a, gap=abs(gap), by=how,
                top2_gap=float(top2[0] - top2[1]),
                bound=PREFIX_LOGIT_TOL * float(logits.abs().max()))


def _hold_prefix(label: str, cfg, params, hit: dict, miss: dict) -> dict:
    """A hit run against a miss run of the same traffic: per conversation,
    turns compared in order until the first that parts (later prompts carry
    different answers); first-token logits compared wherever both runs
    admitted the same prompt. Where a part's gap from the bf16 plain
    recomputation passes its bound and the weights are plain, an f32
    recomputation of the same weights is a second witness: the hit's
    token holds if it lies within the bound of the f32 choice. (Sampled
    draws over random weights' flat logits can part the bf16 reference
    from both runs: on llama-3.2-1b seed 9 it chose a third token, 0.62
    logit from the hit's, where f32 chose the hit's token.)"""
    by = {(r["conv"], r["turn"], tuple(r["prompt"])): r for r in miss["records"]}
    plain = all(isinstance(t, torch.Tensor) for stack in params.values()
                for t in (stack.values() if isinstance(stack, dict) else [stack]))
    p32 = None
    parts, compared = [], 0
    for conv in sorted({r["conv"] for r in hit["records"]}):
        for r in sorted((r for r in hit["records"] if r["conv"] == conv),
                        key=lambda r: r["turn"]):
            m = by.get((conv, r["turn"], tuple(r["prompt"])))
            if m is None:
                break
            compared += 1
            if m["ids"] != r["ids"]:
                part = _part_gap(cfg, params, r["prompt"], m["ids"], r["ids"], r["kw"])
                if part["gap"] > part["bound"] and plain:
                    if p32 is None:
                        p32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
                                   else v.float()) for k, v in params.items()}
                    part["f32_witness"] = _part_gap(dataclasses.replace(cfg, dtype="float32"),
                                                    p32, r["prompt"], m["ids"], r["ids"], r["kw"])
                parts.append(dict(conv=conv, turn=r["turn"], match=r["match"], **part))
                break
    del p32
    diffs = [float((hit["firsts"][k] - v).abs().max()) / float(v.abs().max())
             for k, v in miss["firsts"].items() if k in hit["firsts"]]
    out = dict(compared=compared, parts=parts, first_logit_cmp=len(diffs),
               first_logit_max_rel_diff=max(diffs, default=None))
    log(f"[{label} hold] " + json.dumps(out))
    check(diffs and max(diffs) <= PREFIX_LOGIT_TOL,
          f"{label}: first-token logits of hits and misses differ by "
          f"{max(diffs, default=None)} of the largest |logit| (tol {PREFIX_LOGIT_TOL})")
    for part in parts:
        w = part.get("f32_witness")
        check(part["gap"] <= part["bound"] or (w is not None and w["gap"] <= w["bound"]),
              f"{label}: a hit's ids part from the miss's away from a near tie: {part}")
    return out


def _ttfts(records, hits: bool) -> dict:
    xs = [r["ttft"] * 1e3 for r in records if (r["match"] > 0) == hits]
    return dict(n=len(xs), p50_ms=statistics.median(xs) if xs else None,
                max_ms=max(xs, default=None))


def _prefix_launches(label: str, L: int, run: dict) -> None:
    """B1 = layers x single-shot admissions, B2 = layers x (decode steps +
    prefill chunks), both above 0: every hit ran its tail as chunks through
    B2, every short miss through B1."""
    n, m = run["launches"], run["metrics"]
    check(n["flash_prefill"] == L * m["admissions"] and n["flash_prefill"] > 0,
          f"{label}: B1 launches {n['flash_prefill']} != {L} x {m['admissions']} admissions")
    check(n["paged_attention"] == L * (m["decode_steps"] + m["prefill_chunks"])
          and n["paged_attention"] > 0,
          f"{label}: B2 launches {n['paged_attention']} != {L} x ({m['decode_steps']} steps + "
          f"{m['prefill_chunks']} chunks)")


def _tiny_exact(small, p_small) -> dict:
    """The small f32 model on the card: a chat on the dense and the chunked
    paged engine with and without the cache, and two growing requests on a
    12-page pool (swap) against an ample pool: identical ids."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    def engine(**kw):
        return Engine(small, p_small, ByteTokenizer(small.vocab_size), device="cuda",
                      engine_cfg=EngineConfig(max_slots=2, max_seq=256, block_sizes=(8,),
                                              min_prefill_bucket=16, **kw))

    def run(eng, prompt, n=10, **kw):
        return [e.token_id for e in eng.submit(GenRequest(
            prompt_ids=prompt, max_new_tokens=n, ignore_eos=True, **kw)) if e.kind == "token"]

    sys_ids = [(j * 7) % 250 + 1 for j in range(70)]
    out = {}
    for layout, kw in (("dense", {}), ("paged", dict(kv_pages=40, kv_page_size=16,
                                                     prefill_chunk=32))):
        got = []
        for entries in (8, 0):
            eng = engine(prefix_cache_entries=entries, **kw)
            try:
                a = sys_ids + [3, 5, 8]
                ids = [run(eng, a), run(eng, sys_ids + [21, 34], temperature=0.8, top_p=0.9,
                                        seed=7)]
                ids.append(run(eng, a + ids[0] + [9, 10]))
                got.append((ids, eng.metrics()["prefix_hits"]))
            finally:
                eng.stop()
        out[f"hit_equals_miss_{layout}"] = got[0][0] == got[1][0]
        check(got[0][0] == got[1][0] and got[0][1] == 2 and got[1][1] == 0,
              f"prefix_swap tiny f32 {layout}: hit ids differ from miss ids, or hits {got}")
    pa, pb = [(j * 7) % 250 + 1 for j in range(40)], [(j * 3) % 250 + 1 for j in range(41)]
    swaps = {}
    for pages in (40, 12):
        eng = engine(kv_pages=pages, kv_page_size=16, prefix_cache_entries=0,
                     kv_preempt="swap")
        try:
            ha = eng.submit(GenRequest(prompt_ids=pa, max_new_tokens=100, ignore_eos=True))
            time.sleep(0.05)  # pa is older: pb is the victim
            hb = eng.submit(GenRequest(prompt_ids=pb, max_new_tokens=100, ignore_eos=True,
                                       temperature=0.9, top_p=0.9, seed=1234))
            swaps[pages] = ([[e.token_id for e in h if e.kind == "token"] for h in (ha, hb)],
                            eng.metrics()["kv_preempt_swaps"])
        finally:
            eng.stop()
    out["swap_equals_unpressured"] = swaps[12][0] == swaps[40][0]
    out["tiny_swaps"] = swaps[12][1]
    check(swaps[12][0] == swaps[40][0] and swaps[12][1] > 0,
          f"prefix_swap tiny f32: swapped ids differ or no swap ({swaps[12][1]} swaps)")
    return out


def _prefix_chat(cfg, params, before: int) -> dict:
    """The chat traffic on the paged engine after warmup(), with the default
    prefix knobs (hit) and with prefix_cache_entries=0 (miss): launch
    identities, graphs replayed, hits, and the hit run held to the miss run
    (`_hold_prefix`)."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    L = cfg.num_layers
    runs = {}
    for label, entries in (("hit", 8), ("miss", 0)):
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE, prefix_cache_entries=entries))
        eng.warmup()
        graphs = eng.metrics()["decode_graphs"]
        run = _conversations(eng)
        m = eng.metrics()
        eng.stop()
        run["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - before
        _prefix_launches(f"prefix_swap chat {label}", L, run)
        rm = run["metrics"]
        check(m["decode_graphs"] == graphs and rm["decode_graph_captures"] == 0
              and rm["decode_graph_replays"] == rm["decode_blocks"] > 0,
              f"prefix_swap chat {label}: graphs {graphs} -> {m['decode_graphs']}, "
              f"{rm['decode_graph_replays']} replays of {rm['decode_blocks']} blocks")
        runs[label] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    hit, miss = runs["hit"], runs["miss"]
    hm = hit["metrics"]
    check(hm["prefix_hits"] >= PREFIX_CONVS - 1 and miss["metrics"]["prefix_hits"] == 0,
          f"prefix_swap chat: {hm['prefix_hits']} hits with the cache")
    chat = dict(
        hold=_hold_prefix("prefix_swap chat", cfg, params, hit, miss),
        prefix_hits=int(hm["prefix_hits"]), prefix_tokens=int(hm["prefix_tokens"]),
        prefix_host_hits=int(hm["prefix_host_hits"]),
        prefix_entries=int(hm["prefix_entries"]), kv_swap_bytes_out=int(hm["kv_swap_bytes_out"]),
        ttft_hit=_ttfts(hit["records"], True), ttft_miss_in_hit_run=_ttfts(hit["records"], False),
        ttft_miss_run=_ttfts(miss["records"], False),
        decode_tok_s={k: r["decode_tok_s"] for k, r in runs.items()},
        wall_s={k: r["wall_s"] for k, r in runs.items()},
        peak_memory_bytes={k: r["peak_memory_bytes"] for k, r in runs.items()},
        prefill_chunks={k: int(r["metrics"]["prefill_chunks"]) for k, r in runs.items()},
        launches={k: r["launches"] for k, r in runs.items()})
    log(f"[prefix_swap chat {cfg.name}, {L} layers] " + json.dumps(chat))
    return {"chat": chat,
            **{f"chat_{k}_run": {n: v for n, v in r.items() if n not in ("records", "firsts")}
               for k, r in runs.items()}}


def phase_prefix_swap(small, p_small) -> dict:
    """llama-3.2-1b at full width, 4 of its 16 layers (bf16, seeded random
    weights, ByteTokenizer), after warmup(): (a) the chat traffic on the
    paged engine (pages of 128, chunks of 512, default prefix knobs), then
    the same traffic with prefix_cache_entries=0 (`_prefix_chat`); (b) 8
    requests of 1024-1500 tokens and 256 new tokens each on a 96-page pool
    (auto swaps spans up to 64 MiB) against a 256-page one; (c) a
    16,384-token prompt on the hierarchical + spill engine (sink 128,
    window 4096), then a request extending it: its save restores the
    spilled pages, its entry pins table pages, and the extension hits, with
    the ids of an engine without the cache; (d) the small f32 model's exact
    checks."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = _arch_1b()
    L = cfg.num_layers
    params = llama.init_params(cfg, seed=7, device="cuda")
    out = _prefix_chat(cfg, params, before)
    # (b) swap at full width, against recompute on the same pool and an
    # ample pool.
    swap = {}
    for label, kw in (("pressured", SWAP_ENGINE),
                      ("recompute", dict(SWAP_ENGINE, kv_preempt="recompute")),
                      ("ample", PAGED_ENGINE)):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**kw))
        r = _serve(eng, SWAP_PROMPTS, max_new=256, keep_ids=True)
        m = eng.metrics()
        r.update(kv_preempt_swaps=int(m["kv_preempt_swaps"]),
                 kv_preempt_recomputes=int(m["kv_preempt_recomputes"]),
                 kv_swap_bytes_out=int(m["kv_swap_bytes_out"]),
                 kv_swap_bytes_in=int(m["kv_swap_bytes_in"]))
        swap[label] = r
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    p, rc, a = swap["pressured"], swap["recompute"], swap["ample"]
    check(p["kv_preempt_swaps"] > 0 and p["kv_preempt_recomputes"] == 0,
          f"prefix_swap swap: {p['kv_preempt_swaps']} swaps of {p['kv_preemptions']} "
          "preemptions")
    check(rc["kv_preempt_swaps"] == 0, "prefix_swap swap: the recompute run swapped")
    for r in (p, rc):
        _check_graphs("prefix_swap swap", r)
        check(r["launches"]["paged_attention"] == L * (r["decode_steps"] + r["prefill_chunks"]),
              f"prefix_swap swap: B2 launches {r['launches']['paged_attention']}")
    prompts = _serve_prompts(SWAP_PROMPTS)
    parts = []
    for label, r in (("swap", p), ("recompute", rc)):
        for i, (want, got) in enumerate(zip(a["ids"], r["ids"])):
            if want != got:
                kw = dict(temperature=0.8, top_p=0.9, seed=100 + i) if i % 2 else {}
                parts.append(dict(run=label, request=i,
                                  **_part_gap(cfg, params, prompts[i], want, got, kw)))
    log("[prefix_swap swap parts] " + json.dumps(parts))
    for part in parts:
        check(part["gap"] <= part["bound"],
              f"prefix_swap swap: ids part from the unpressured run's away from a tie: {part}")
    swap_sum = dict(ids_equal={"swap": p["ids"] == a["ids"], "recompute": rc["ids"] == a["ids"]},
                    parts=parts,
                    **{k: {lb: r[k] for lb, r in swap.items()} for k in (
                        "kv_preemptions", "kv_preempt_swaps", "kv_preempt_recomputes",
                        "kv_swap_bytes_out", "kv_swap_bytes_in", "kv_pages_peak", "wall_s",
                        "decode_tok_s", "prefill_chunks", "ttft_ms_max")})
    log(f"[prefix_swap swap llama-3.2-1b, {ONEB_LAYERS} layers] " + json.dumps(swap_sum))
    for r in swap.values():
        del r["ids"]
    out["swap"], out["swap_runs"] = swap_sum, swap
    # (c) long context: restore the spilled pages at the save, then hit.
    gen = torch.Generator().manual_seed(13)
    long_prompt = torch.randint(0, 256, (16384,), generator=gen).tolist()
    ext = torch.randint(0, 256, (40,), generator=gen).tolist()
    long = {}
    for label, entries in (("hit", 8), ("fresh", 0)):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**LONG_PREFIX_ENGINE, prefix_cache_entries=entries))
        if entries:  # the first turn: its save restores the spilled pages
            long["first"] = [e.token_id for e in eng.submit(GenRequest(
                prompt_ids=long_prompt, max_new_tokens=32, ignore_eos=True)) if e.kind == "token"]
        prompt2 = long_prompt + long["first"] + ext
        _zero_counts()
        m0 = eng.metrics()
        t0 = time.monotonic()
        h = eng.submit(GenRequest(prompt_ids=prompt2, max_new_tokens=32, ignore_eos=True))
        ttft, ids = None, []
        for ev in h:
            if ev.kind == "token":
                ttft = ttft or time.monotonic() - t0
                ids.append(ev.token_id)
        n = _read_counts()
        m = eng.metrics()
        d = {k: m[k] - m0[k] for k in m}
        check(n["paged_attention"] == L * (d["decode_steps"] + d["prefill_chunks"])
              and n["paged_attention"] > 0,
              f"prefix_swap long {label}: B2 launches {n['paged_attention']}")
        long[label] = dict(ids=ids, ttft_ms=ttft * 1e3, launches=n,
                           prefill_chunks=int(d["prefill_chunks"]),
                           prefix_hits=int(m["prefix_hits"]), prefix_tokens=int(m["prefix_tokens"]),
                           kv_pages_spilled=int(m["kv_pages_spilled"]),
                           kv_pages_restored=int(m["kv_pages_restored"]),
                           entry_tps=sum(len(e.get("tps", [])) for e in eng._prefix_entries))
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    lh, lf = long["hit"], long["fresh"]
    long_sum = dict(ids_equal=lh["ids"] == lf["ids"],
                    **{k: {"hit": lh[k], "fresh": lf[k]} for k in (
                        "ttft_ms", "prefill_chunks", "prefix_hits", "prefix_tokens",
                        "kv_pages_spilled", "kv_pages_restored", "entry_tps")})
    log(f"[prefix_swap long llama-3.2-1b, {ONEB_LAYERS} layers] " + json.dumps(long_sum))
    check(lh["kv_pages_spilled"] > 0 and lh["kv_pages_restored"] > 0 and lh["entry_tps"] > 0
          and lh["prefix_hits"] == 1 and lh["prefix_tokens"] >= 16384 and lf["prefix_hits"] == 0,
          f"prefix_swap long: no restore-then-hit: {long_sum}")
    check(lh["ids"] == lf["ids"], "prefix_swap long: the hit's ids differ from a fresh engine's")
    out["long"] = long_sum
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (d) exact on the card.
    out["tiny"] = _tiny_exact(small, p_small)
    log("[prefix_swap tiny-d64 f32] " + json.dumps(out["tiny"]))
    return out


def phase_prefix_8b(qmodel: dict) -> dict:
    """llama-3-8b int4 on an fp8 pool with kv_scale 2 (phase 8's engine):
    a 1100-token prompt, then one sharing its first 1024 tokens, on an
    engine with the cache and on one without. The hit's tail chunk walks
    the shared fp8 pages through B2, its products go through B3 and its
    first token through B4; its ids are held to the miss's as in the chat
    run."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg, params = _first_layers(qmodel["cfg"], qmodel["int4"], QUANT_ENGINE_LAYERS)
    L = cfg.num_layers
    gen = torch.Generator().manual_seed(17)
    base = torch.randint(0, 256, (1100,), generator=gen).tolist()
    second = base[:1024] + torch.randint(0, 256, (60,), generator=gen).tolist()
    runs = {}
    for label, entries in (("hit", 8), ("miss", 0)):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE, kv_cache_dtype="fp8", kv_scale=2.0,
                                             prefix_cache_entries=entries))
        firsts, install = {}, eng._install_first

        def spy(logits, prompt, lens, *a, firsts=firsts, install=install):
            firsts[tuple(prompt[0, :int(lens[0])].tolist())] = logits[0].float().cpu()
            return install(logits, prompt, lens, *a)

        eng._install_first = spy
        list(eng.submit(GenRequest(prompt_ids=base, max_new_tokens=16, ignore_eos=True)))
        _zero_counts()
        m0 = eng.metrics()
        t0 = time.monotonic()
        ttft, ids = None, []
        for ev in eng.submit(GenRequest(prompt_ids=second, max_new_tokens=32, ignore_eos=True)):
            if ev.kind == "token":
                ttft = ttft or time.monotonic() - t0
                ids.append(ev.token_id)
        n = _read_counts()
        m = eng.metrics()
        d = {k: m[k] - m0[k] for k in m}
        eng.stop()
        check(n["paged_attention"] == L * (d["decode_steps"] + d["prefill_chunks"])
              and n["quant_matmul"] > 0 and n["quant_unembed"] > 0,
              f"prefix_8b {label}: launches {n}")
        runs[label] = dict(ids=ids, ttft_ms=ttft * 1e3, launches=n,
                           prefix_hits=int(d["prefix_hits"]), prefix_tokens=int(d["prefix_tokens"]),
                           prefill_chunks=int(d["prefill_chunks"]),
                           first=firsts[tuple(second)])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    h, m = runs["hit"], runs["miss"]
    check(h["prefix_hits"] == 1 and h["prefix_tokens"] == 1024 and m["prefix_hits"] == 0,
          f"prefix_8b: hits {h['prefix_hits']} ({h['prefix_tokens']} tokens)")
    rel = float((h["first"] - m["first"]).abs().max()) / float(m["first"].abs().max())
    check(rel <= PREFIX_LOGIT_TOL, f"prefix_8b: first-token logits differ by {rel} of the "
                                   f"largest |logit|")
    part = None
    if h["ids"] != m["ids"]:
        part = _part_gap(cfg, params, second, m["ids"], h["ids"], {})
        check(part["gap"] <= part["bound"], f"prefix_8b: ids part away from a tie: {part}")
    out = dict(ids_equal=h["ids"] == m["ids"], part=part, first_logit_rel_diff=rel,
               **{k: {"hit": h[k], "miss": m[k]} for k in (
                   "ttft_ms", "prefix_hits", "prefix_tokens", "prefill_chunks", "launches")})
    log("[prefix_swap llama-3-8b int4 + fp8] " + json.dumps(out))
    return out


# --------------------------------------------------------------------------- #
# 19. grammar: constrained decoding and tool calling
# --------------------------------------------------------------------------- #

# test_grammar_dfa.py's SCHEMAS[1] (a small automaton: "fast" mode, one
# gather of an [S, V] next-state table a step) and TOOL_SCHEMA (~678
# states: "walk" mode, the token's char classes walked through [S, C]).
GRAMMAR_SCHEMAS = {
    "fast": {"type": "object", "properties": {"a": {"type": "integer"},
                                              "b": {"type": "boolean"}},
             "required": ["a", "b"]},
    "walk": {"type": "object", "required": ["name", "arguments"], "properties": {
        "name": {"enum": ["get_weather", "search_web"]},
        "arguments": {"type": "object", "required": ["location"], "properties": {
            "location": {"type": "string"}, "unit": {"enum": ["celsius", "fahrenheit"]},
            "days": {"type": "integer"}}}}},
}
# Never prewarmed, one per request of round C: a schema's first request
# always takes the host candidate walk (its tables build off the loop).
GRAMMAR_NOVEL = [{"type": "object", "properties": {key: {"type": "integer"},
                                                   "ok": {"type": "boolean"}},
                  "required": [key, "ok"]} for key in ("id", "count")]
GRAMMAR_NEW = 128
GRAMMAR_TOOL = [{"type": "function", "function": {
    "name": "get_weather", "description": "The weather in a unit",
    "parameters": {"type": "object", "properties": {"unit": {"enum": ["celsius", "fahrenheit"]}},
                   "required": ["unit"]}}}]
GRAMMAR_GBNF = 'root ::= ("yes" | "no" | [0-9]+ " apples") "."'


def _grammar_prompts(seed: int, n: int, longest: int = 1200) -> list[list[int]]:
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (int(torch.randint(200, longest + 1, (1,), generator=gen)),),
                          generator=gen).tolist() for _ in range(n)]


def _grammar_ok(schema, text: str, finish: str) -> bool:
    """A legal prefix of the schema's language; a whole value when the
    request ended with "stop"."""
    from localai_tpu_torch.functions.jsonschema import JsonSchemaMachine

    if not JsonSchemaMachine(schema).feed_text(text):
        return False
    if finish == "stop":
        try:
            json.loads(text)
        except ValueError:
            return False
    return True


def _grammar_round(eng, prompts, schemas) -> dict:
    """Serve one request per prompt at once (request i under schemas[i], None
    = unconstrained; even i greedy, odd i seeded top-p 0.9 at T 0.8),
    GRAMMAR_NEW tokens each. After every decode block each live DFA slot's
    device state is held against a numpy walk of its emitted ids through
    the host tables. Launch counters go to 0 just before the run and are
    read just after."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.functions.jsonschema import GrammarConstraint
    from localai_tpu_torch.ops.grammar import dfa_state_after

    run = eng._run_block
    held = {"blocks": 0, "slots": 0, "bad": []}

    def checked():
        ok = run()
        gs = eng.d_gstate.cpu().tolist()
        held["blocks"] += 1
        for i, s in enumerate(eng.slots):
            if s is not None and eng.h_active[i] and s.dfa:
                held["slots"] += 1
                want = dfa_state_after(eng._dfa["host"], s.generated)
                if gs[i] != want:
                    held["bad"].append((i, gs[i], want))
        return ok

    reqs = [GenRequest(prompt_ids=p, max_new_tokens=GRAMMAR_NEW,
                       grammar=GrammarConstraint(sc) if sc is not None else None,
                       **(dict(temperature=0.8, top_p=0.9, seed=200 + i) if i % 2 else {}))
            for i, (p, sc) in enumerate(zip(prompts, schemas))]
    results: list = [None] * len(reqs)

    def consume(i, h):
        results[i] = list(h)

    _zero_counts()
    m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
    eng._run_block = checked
    t0 = time.monotonic()
    try:
        threads = []
        for i, r in enumerate(reqs):
            th = threading.Thread(target=consume, args=(i, eng.submit(r)))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
    finally:
        del eng._run_block
    wall = time.monotonic() - t0
    launches = _read_counts()
    m = eng.metrics()
    check(all(not th.is_alive() for th in threads), "grammar: a request never finished")
    out = dict(ids=[], texts=[], finish=[], launches=launches, wall_s=wall,
               decode_tok_s=(eng._decode_tokens - tok0) / max(eng._decode_time - dt0, 1e-9),
               decode_ms_per_step=(eng._decode_time - dt0) * 1e3
               / max(m["decode_steps"] - m0["decode_steps"], 1),
               held_blocks=held["blocks"], held_slot_states=held["slots"],
               held_bad=held["bad"][:8],
               metrics={k: m[k] - m0.get(k, 0.0) for k in (
                   "admissions", "decode_blocks", "decode_steps", "prefill_chunks",
                   "chunked_admits", "prefix_hits", "decode_graph_captures",
                   "decode_graph_replays", "grammar_dfa_tokens", "tokens_generated")
                   if k in m})
    for i, evs in enumerate(results):
        check(evs[-1].kind == "done", f"grammar: request {i} ended with {evs[-1].kind}: "
                                      f"{evs[-1].error}")
        out["ids"].append([e.token_id for e in evs if e.kind == "token"])
        out["texts"].append("".join(e.text for e in evs))
        out["finish"].append(evs[-1].finish_reason)
    return out


def _grammar_http() -> dict:
    """The port's server on llama-3.2-1b (4 of 16 layers, the synthetic byte
    tokenizer): a tool call required of one tool, whole and streamed, a
    json_schema response format and a GBNF grammar on /v1/completions
    (streamed), their schemas prewarmed on the served engine. EOS gets +50
    and the space tokens -50, so a reply is compact and ends once its
    grammar is complete."""
    from localai_tpu_torch.functions.gbnf import CompiledGrammar, GbnfConstraint
    from localai_tpu_torch.functions.jsonschema import tool_call_schema

    bias = {str(t): -50.0 for t in range(128256) if t % 95 == 0 and t not in (256, 257, 258)}
    bias["257"] = 50.0
    msgs = [{"role": "user", "content": "What is the weather in Paris?"}]
    reqs = [
        ("/v1/chat/completions", {"messages": msgs, "tools": GRAMMAR_TOOL,
                                  "tool_choice": "required", "max_tokens": 160}),
        ("/v1/chat/completions", {"messages": msgs, "tools": GRAMMAR_TOOL,
                                  "tool_choice": "required", "max_tokens": 160, "stream": True}),
        ("/v1/chat/completions", {"messages": msgs, "max_tokens": 160, "response_format": {
            "type": "json_schema", "json_schema": {"schema": GRAMMAR_SCHEMAS["fast"]}}}),
        ("/v1/completions", {"prompt": "How many?", "grammar": GRAMMAR_GBNF, "max_tokens": 32,
                             "stream": True}),
    ]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        _write_models_dir(root, tenants=False)
        manager, server, base = _start_server(root)
        try:
            warm = _http(base, "/v1/completions", {"model": "llama-1b", "prompt": "warm up",
                                                   "max_tokens": 2}, time.monotonic())
            check(warm["status"] == 200, f"grammar http: warm request {warm}")
            eng = manager.peek("llama-1b").engine
            for schema in (tool_call_schema(GRAMMAR_TOOL), GRAMMAR_SCHEMAS["fast"],
                           {"__gbnf__": GRAMMAR_GBNF}):
                check(eng.prewarm_grammar(schema), f"grammar http: no DFA for {schema}")
            m0 = eng.metrics()
            _zero_counts()
            results = [_http(base, path, {"model": "llama-1b", "logit_bias": bias, **body},
                             time.monotonic()) for path, body in reqs]
            launches = _read_counts()
            m1 = eng.metrics()
            generated = int(m1["tokens_generated"] - m0["tokens_generated"])
            out["grammar_dfa_tokens"] = int(m1.get("grammar_dfa_tokens", 0)
                                            - m0.get("grammar_dfa_tokens", 0))
        finally:
            server.shutdown()
            manager.shutdown()
    usage_sum, replies = 0, []
    for i, ((path, body), res) in enumerate(zip(reqs, results)):
        check(res["status"] == 200, f"grammar http: request {i} got HTTP {res['status']}: "
                                    f"{res.get('body')}")
        if body.get("stream"):
            check(res["frames"][-1] == "[DONE]", f"grammar http: stream {i} did not end in [DONE]")
            chunks = [json.loads(f) for f in res["frames"][:-1]]
            check(not any("error" in c for c in chunks), f"grammar http: stream {i} errored")
            choices = [c["choices"][0] for c in chunks]
            deltas = [c.get("delta", c) for c in choices]
            text = "".join(d.get("content") or d.get("text") or "" for d in deltas)
            calls = [t for d in deltas for t in d.get("tool_calls") or []]
            finish, usage = choices[-1]["finish_reason"], chunks[-1]["usage"]
            if "tools" not in body:  # every token streams as its own chunk
                ntok = sum(1 for c in choices if c["finish_reason"] is None
                           and ("text" in c or "content" in c.get("delta", {})))
                check(usage["completion_tokens"] == ntok,
                      f"grammar http: stream {i}: {ntok} token chunks, usage {usage}")
        else:
            c = res["body"]["choices"][0]
            msg = c.get("message") or {}
            text = msg.get("content") or c.get("text") or ""
            calls, finish, usage = msg.get("tool_calls") or [], c["finish_reason"], \
                res["body"]["usage"]
        usage_sum += usage["completion_tokens"]
        if "tools" in body:
            check(finish == "tool_calls" and calls,
                  f"grammar http: request {i} ended {finish!r} with calls {calls}, text {text!r}")
        if finish == "tool_calls":
            for call in calls:
                args = json.loads(call["function"]["arguments"])
                check(call["function"]["name"] == "get_weather"
                      and args.get("unit") in ("celsius", "fahrenheit"),
                      f"grammar http: request {i}: call {call}")
        elif "response_format" in body:
            check(_grammar_ok(GRAMMAR_SCHEMAS["fast"], text, finish),
                  f"grammar http: json_schema reply {text!r} ({finish})")
        elif "grammar" in body:
            g = GbnfConstraint(CompiledGrammar(GRAMMAR_GBNF))
            check(g.advance(text) and (finish != "stop" or g.complete()),
                  f"grammar http: GBNF reply {text!r} ({finish})")
        replies.append(dict(path=path, stream=bool(body.get("stream")), finish=finish,
                            text=text[:120], calls=[c["function"] for c in calls],
                            completion_tokens=usage["completion_tokens"]))
    check(usage_sum == generated, f"grammar http: usage sums to {usage_sum}, the engine "
                                  f"generated {generated}")
    check(launches["flash_prefill"] > 0 and launches["paged_attention"] > 0,
          f"grammar http: launches {launches}")
    out.update(replies=replies, launches=launches)
    return out


def phase_grammar() -> dict:
    """llama-3.2-1b at full width, 4 of its 16 layers (bf16, seeded random
    weights) with the synthetic byte tokenizer (every id a printable
    character, so the masks are dense) on phase 18's paged engine without
    the prefix cache: ops/grammar
    on the card against the CPU for an [8, 128256] batch in both modes; the
    table builds and their copies to the card; warmup(grammar=True) after
    prewarming both schemas; then rounds A (4 requests on the fast schema,
    4 unconstrained), B (the same prompts on the walk schema) and C (2 on
    schemas never prewarmed: the host walk, 2 unconstrained), each beside the
    same batch unconstrained; then the port's server."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import SyntheticByteTokenizer
    from localai_tpu_torch.functions import dfa as dfa_mod
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops import grammar

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _arch_1b()
    L, V = cfg.num_layers, cfg.vocab_size
    params = llama.init_params(cfg, seed=7, device="cuda")
    tok = SyntheticByteTokenizer(V)
    # The prefix cache off: a round and its unconstrained batch then admit
    # every prompt by the same chunk grid (a hit's would differ in bf16).
    eng = Engine(cfg, params, tok, device="cuda",
                 engine_cfg=EngineConfig(**PAGED_ENGINE, prefix_cache_entries=0))
    out: dict = {"tables": {}}
    tables = {}
    for mode, schema in GRAMMAR_SCHEMAS.items():
        t0 = time.monotonic()
        check(eng.prewarm_grammar(schema), f"grammar: {mode} schema has no DFA")
        build_s = time.monotonic() - t0
        tables[mode] = dfa_mod.tables_for(schema, eng._token_strings(), set(tok.eos_ids), V,
                                          tokenizer_id=eng._tok_fingerprint(), cached_only=True)
        layout = eng._dfa_layout(tables[mode])
        check(layout[0] == mode, f"grammar: the {mode} schema compiled to {layout}")
        out["tables"][mode] = dict(states=int(tables[mode].trans.shape[0]),
                                   classes=int(tables[mode].trans.shape[1]), layout=list(layout),
                                   build_s=build_s)
    # ops/grammar: the card's bits against the CPU's.
    g = torch.Generator().manual_seed(19)
    bits = {}
    for mode, tt in tables.items():
        S1 = tt.trans.shape[0]
        state = torch.randint(0, S1, (8,), generator=g, dtype=torch.int32)
        legal = np.unpackbits(tt.mask_bits[state.numpy()], axis=1, bitorder="little")[:, :V]
        toks = torch.tensor([int(np.flatnonzero(r)[k * 997 % max(int(r.sum()), 1)])
                             if r.any() else 0 for k, r in enumerate(legal)])
        table = torch.from_numpy(tt.next_tok if mode == "fast" else tt.trans)
        cls, mask = torch.from_numpy(tt.tok_cls), torch.from_numpy(tt.mask_bits)

        def both(fn):
            return fn("cuda").cpu(), fn("cpu")

        a = both(lambda d: grammar.dfa_allowed(mask.to(d), state.to(d), V))
        n = both(lambda d: grammar.dfa_advance(mode, table.to(d), cls.to(d), state.to(d),
                                               toks.to(d)))
        bits[mode] = dict(allowed_equal=bool(torch.equal(*a)), advance_equal=bool(torch.equal(*n)),
                          shape=list(a[0].shape))
        check(torch.equal(*a) and torch.equal(*n) and list(a[0].shape) == [8, V],
              f"grammar: ops/grammar {mode} on the card differs from the CPU: {bits[mode]}")
    out["ops_bits"] = bits
    t0 = time.monotonic()
    eng.warmup(grammar=True)
    out["warmup_s"] = time.monotonic() - t0
    out["graphs_after_warmup"] = int(eng.metrics()["decode_graphs"])
    for mode, schema in GRAMMAR_SCHEMAS.items():  # in place: the buffers are at size
        layout = eng._dfa_layout(tables[mode])
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._dfa_install(dfa_mod.schema_key(schema), tables[mode], layout)
        torch.cuda.synchronize()
        out["tables"][mode]["copy_ms"] = (time.monotonic() - t0) * 1e3
    out["buffer_dims"] = list(eng._g_dims)
    eng.start()
    # Prompts of 200-1200 tokens: in A and B two of the constrained and two
    # of the unconstrained admit single-shot (B1), the others in chunks.
    ab_prompts, c_prompts = _grammar_prompts(22, 8), _grammar_prompts(23, 4)
    rounds = {}
    for label, prompts, schemas in (
            ("A", ab_prompts, [GRAMMAR_SCHEMAS["fast"]] * 4 + [None] * 4),
            ("B", ab_prompts, [GRAMMAR_SCHEMAS["walk"]] * 4 + [None] * 4),
            ("C", c_prompts, GRAMMAR_NOVEL + [None] * 2),
            ("AB_plain", ab_prompts, [None] * 8),
            ("C_plain", c_prompts, [None] * 4),
            ("C_plain_1", c_prompts, [None] * 4)):
        if label == "C_plain_1":
            # Every block one step: the schedule a live host-walk slot
            # imposes on its neighbours.
            eng._pick_block_size = lambda: 1
        try:
            r = _grammar_round(eng, prompts, schemas)
        finally:
            eng.__dict__.pop("_pick_block_size", None)
        rounds[label] = r
        rm = r["metrics"]
        check(r["launches"]["flash_prefill"] == L * rm["admissions"]
              and r["launches"]["paged_attention"] == L * (rm["decode_steps"]
                                                          + rm["prefill_chunks"])
              and r["launches"]["paged_attention"] > 0,
              f"grammar {label}: launches {r['launches']} for {rm}")
        check(rm["decode_graph_captures"] + rm["decode_graph_replays"] == rm["decode_blocks"] > 0,
              f"grammar {label}: {rm}")
        for i, sc in enumerate(schemas):
            if sc is not None:
                check(_grammar_ok(sc, r["texts"][i], r["finish"][i]),
                      f"grammar {label}: request {i} ({r['finish'][i]}) is not in its "
                      f"language: {r['texts'][i]!r}")
        check(not r["held_bad"], f"grammar {label}: device DFA states != the host walk: "
                                 f"{r['held_bad']}")
    for label in ("A", "B"):
        rm = rounds[label]["metrics"]
        check(rm.get("grammar_dfa_tokens", 0) > 0 and rounds[label]["held_slot_states"] > 0,
              f"grammar {label}: the DFA did not serve: {rm}")
        check(rm["decode_graph_captures"] == 0, f"grammar {label}: captured while serving: {rm}")
    check(rounds["C"]["metrics"].get("grammar_dfa_tokens", 0) == 0,
          f"grammar C: the never-prewarmed schema rode the DFA: {rounds['C']['metrics']}")
    # The unconstrained requests against the same requests served with no
    # constrained neighbours. In bf16 a decode step's logits depend on the
    # block it runs in (its rows split between the pool, read by B2, and
    # the block's local window), so they may part at a near tie of a plain
    # prefill, or, in C, where the same batch alone in one-step blocks (what
    # a live host-walk slot imposes) parts the same way.
    parts = []
    for label, plain, first in (("A", "AB_plain", 4), ("B", "AB_plain", 4), ("C", "C_plain", 2)):
        prompts = ab_prompts if plain == "AB_plain" else c_prompts
        for i in range(first, len(prompts)):
            want, got = rounds[plain]["ids"][i], rounds[label]["ids"][i]
            if want != got:
                kw = dict(temperature=0.8, top_p=0.9, seed=200 + i) if i % 2 else {}
                part = dict(round=label, request=i,
                            **_part_gap(cfg, params, prompts[i], want, got, kw))
                one_step = rounds["C_plain_1"]["ids"][i] if label == "C" else []
                part["one_step_parts_alike"] = one_step[:part["position"] + 1] == \
                    got[:part["position"] + 1]
                parts.append(part)
    for part in parts:
        check(part["gap"] <= part["bound"] or part["one_step_parts_alike"],
              f"grammar: an unconstrained request parts from its run alone away from a tie "
              f"(and not as one-step blocks part): {part}")
    # Device ms a decode step: one replay of a block's graph (every slot
    # idle: the same layers, the mask and step computed for every row),
    # plain against the fast and the walk DFA; the host walk's one-step
    # block with its candidates.
    eng._stage_block(np.zeros_like(eng.h_active))
    step_ms = {}
    for label, dfa in (("plain", False), ("fast", "fast"), ("walk", "walk")):
        for variant in ("greedy", "filtered"):
            graph = eng._graph_cache[eng._block_key(16, variant, 0, dfa)][0]
            step_ms[f"{label}_{variant}"] = cuda_time_ms(graph.replay, reps=5, warmup=1) / 16
    for label, dfa in (("host_walk", False), ("host_walk_beside_walk", "walk")):
        graph = eng._graph_cache[eng._block_key(1, "grammar", 0, dfa)][0]
        step_ms[label] = cuda_time_ms(graph.replay, reps=20, warmup=2)
    graph = eng._graph_cache[eng._block_key(1, "filtered", 0)][0]
    step_ms["plain_filtered_one_step"] = cuda_time_ms(graph.replay, reps=20, warmup=2)
    eng.stop()
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    out["http"] = _grammar_http()
    summary = dict(
        tables=out["tables"], ops_bits=bits, warmup_s=out["warmup_s"],
        graphs_after_warmup=out["graphs_after_warmup"], buffer_dims=out["buffer_dims"],
        device_ms_per_step=step_ms,
        decode_tok_s={k: r["decode_tok_s"] for k, r in rounds.items()},
        decode_ms_per_step={k: r["decode_ms_per_step"] for k, r in rounds.items()},
        wall_s={k: r["wall_s"] for k, r in rounds.items()},
        metrics={k: r["metrics"] for k, r in rounds.items()},
        held={k: (r["held_blocks"], r["held_slot_states"]) for k, r in rounds.items()},
        finish={k: r["finish"] for k, r in rounds.items()},
        texts={k: [t[:80] for t, s in zip(r["texts"], r["finish"])][:4]
               for k, r in rounds.items() if k in ("A", "B", "C")},
        unconstrained_parts=parts,
        http=out["http"]["replies"])
    log(f"[grammar llama-3.2-1b, {ONEB_LAYERS} layers] " + json.dumps(summary))
    out["summary"] = summary
    out["runs"] = {f"grammar_{k}": {"launches": r["launches"]} for k, r in rounds.items()}
    out["runs"]["grammar_http"] = {"launches": out["http"]["launches"]}
    return out


TREE_NEW = 64
TREE_LENS = [200, 500, 800, 1200]  # two single-shot primaries (B1), two chunked (B2)
# A logprob from a decode block against log_softmax of a plain prefill of
# the same sequence: |Δ logprob| <= |Δ logit| + |Δ logsumexp| <= 2 x the
# largest logit change, and the bf16 logits of a decode step and of a
# prefill differ by at most PREFIX_LOGIT_TOL of the largest |logit| (18).
TREE_LP_TOL = 2 * PREFIX_LOGIT_TOL
# best_of memory on pages of 64 rows: a branch's own rows (the boundary
# page's copy or its first decode page) take one page, as one page of the
# reference's 16-row pages does; at 128 rows 8 private pages would weigh
# 1.8x a 1024-token prompt's 9.
TREE_BEST_OF = dict(max_slots=8, max_seq=2048, kv_pages=64, kv_page_size=64,
                    prefill_chunk=512, block_sizes=(16, 4, 1), prefix_cache_entries=0)


def _tree_prompts(seed: int, lens: list[int]) -> list[list[int]]:
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (n,), generator=gen).tolist() for n in lens]


def _guard_shared_writes(eng) -> list:
    """Watch every write of `eng` (decode blocks, prefill chunks, a fork's
    boundary-page copies) for a page whose refcount is above 1: a page
    another slot or a prefix entry shares. Returns the list violations go
    to."""
    bad: list = []
    page = eng.ecfg.kv_page_size
    block, chunk, fork = eng._decode_block, eng._dispatch_chunk, eng._dispatch_fork

    def rows(slot_idx, lo, hi, pages):
        for c in range(lo // page, min((hi - 1) // page + 1, len(pages))):
            if pages[c] >= 0 and eng._page_refs[pages[c]] > 1:
                bad.append((slot_idx, c, int(eng._page_refs[pages[c]])))

    def guarded_block(n, *a):
        for i, s in enumerate(eng.slots):
            if s is not None and eng.h_active[i]:
                budget = max(min(n, eng._remaining(s)), 0)
                rows(i, s.sched_rows, s.sched_rows + budget, eng._slot_pages[i])
        return block(n, *a)

    def guarded_chunk(st, n, with_logits=False):
        seg = min(n, len(st["ids"]) - st["offset"])
        width = eng._bucket_for(seg) if with_logits else n
        rows(st["slot"], st["offset"], st["offset"] + width, eng._slot_pages[st["slot"]])
        return chunk(st, n, with_logits)

    def guarded_fork(prompt_ids, forked, copies, *a):
        bad.extend(("copy", b) for _a, b in copies if eng._page_refs[b] != 1)
        return fork(prompt_ids, forked, copies, *a)

    eng._decode_block, eng._dispatch_chunk = guarded_block, guarded_chunk
    eng._dispatch_fork = guarded_fork
    return bad


def _pool_clean(eng, label: str) -> None:
    """Once idle: no refcount below 0, and the free list plus the prefix
    entries' pages are the whole pool."""
    deadline = time.monotonic() + 30
    while any(s is not None for s in eng.slots) or eng._pending:
        check(time.monotonic() < deadline, f"{label}: the engine did not go idle")
        time.sleep(0.01)
    held = {p for e in eng._prefix_entries for p in e["pages"]}
    check(bool((eng._page_refs >= 0).all()), f"{label}: a page refcount went negative")
    check(len(eng._free_pages) + len(held) == eng.ecfg.kv_pages,
          f"{label}: {len(eng._free_pages)} free + {len(held)} cached of "
          f"{eng.ecfg.kv_pages} pages")


def _tree_round(eng, groups: list[tuple[list[int], int]], fork: bool, wave: int = 2) -> dict:
    """Serve choice groups (prompt, seed base) of 4 seeded top-p requests,
    `wave` groups at a time (8 slots: a wave's branches all find a slot),
    through submit_fork or as 4 independent submits. Launch counters go to
    0 just before and are read just after. Returns each request's ids and
    TTFT, each group's TTFT (its last branch's first token), the metric
    deltas and the launches."""
    from localai_tpu_torch.engine.engine import GenRequest

    ids, ttft = {}, {}
    _zero_counts()
    m0 = eng.metrics()
    t_run = time.monotonic()
    for w in range(0, len(groups), wave):
        threads = []
        for g in range(w, min(w + wave, len(groups))):
            prompt, seed = groups[g]
            reqs = [GenRequest(prompt_ids=prompt, max_new_tokens=TREE_NEW, ignore_eos=True,
                               temperature=0.8, top_p=0.9, seed=seed + i) for i in range(4)]
            t0 = time.monotonic()
            hs = eng.submit_fork(reqs) if fork else [eng.submit(r) for r in reqs]

            def consume(key, h, t0):
                first, toks = None, []
                for ev in h:
                    if ev.kind == "token":
                        first = first or time.monotonic() - t0
                        toks.append(ev.token_id)
                    elif ev.kind == "error":
                        toks = None
                ids[key], ttft[key] = toks, first

            for i, h in enumerate(hs):
                th = threading.Thread(target=consume, args=((g, i), h, t0))
                th.start()
                threads.append(th)
        for th in threads:
            th.join(timeout=600)
        check(all(not th.is_alive() for th in threads), "tree: a request never finished")
    wall = time.monotonic() - t_run
    launches = _read_counts()
    m1 = eng.metrics()
    for key, toks in ids.items():
        check(toks is not None and len(toks) == TREE_NEW, f"tree: request {key} ended short")
    group_ttft = [max(ttft[(g, i)] for i in range(4)) * 1e3 for g in range(len(groups))]
    return dict(ids=ids, ttft_ms={k: v * 1e3 for k, v in ttft.items()},
                group_ttft_ms=group_ttft, wall_s=wall, launches=launches,
                metrics={k: m1[k] - m0.get(k, 0.0) for k in m1})


def _tree_launches(label: str, L: int, run: dict, paged: bool = True) -> None:
    """B1 = layers x single-shot admissions; B2 = layers x (decode steps +
    prefill chunks) on a paged pool, 0 on a dense cache."""
    rm, la = run["metrics"], run["launches"]
    b2 = L * (rm["decode_steps"] + rm["prefill_chunks"]) if paged else 0
    check(la["flash_prefill"] == L * rm["admissions"] and la["paged_attention"] == b2
          and (la["paged_attention"] > 0) == paged and la["flash_prefill"] > 0,
          f"{label}: launches {la} for {rm}")
    check(rm["decode_graph_captures"] + rm["decode_graph_replays"] == rm["decode_blocks"] > 0,
          f"{label}: decode blocks not all graphs: {rm}")


def _teacher_hold(cfg, params, prompt, evs, k: int = 5) -> dict:
    """Every event's logprob and top-k against log_softmax of one plain
    forward over prompt + ids (bf16, teacher-forced): |Δ| within
    TREE_LP_TOL of the position's largest |logit|; top-k ids equal, or
    swapped where the teacher's two logprobs lie within that bound."""
    from localai_tpu_torch.models import llama

    toks = [e.token_id for e in evs]
    seq = torch.tensor([list(prompt) + toks[:-1]], dtype=torch.int64, device="cuda")
    with torch.no_grad():
        h, _m, _kv = llama._forward_hidden(cfg, params, seq,
                                           torch.tensor([seq.shape[1]], device="cuda"),
                                           collect_kv=False)
        logits = llama._unembed(cfg, params, h[0, len(prompt) - 1:]).float()
    logp = torch.log_softmax(logits, dim=-1)
    worst, swaps = 0.0, 0
    for p, e in enumerate(evs):
        bound = TREE_LP_TOL * float(logits[p].abs().max())
        d = abs(float(logp[p, e.token_id]) - e.logprob)
        worst = max(worst, d / bound)
        check(d <= bound, f"tree logprobs: position {p}: {e.logprob} against the teacher's "
                          f"{float(logp[p, e.token_id])} (bound {bound})")
        want = torch.topk(logp[p], k).indices.tolist()
        for (gi, gv), wi in zip(e.top_logprobs, want):
            worst = max(worst, abs(float(logp[p, gi]) - gv) / bound)
            if gi != wi:
                swaps += 1
                check(abs(float(logp[p, gi] - logp[p, wi])) <= bound,
                      f"tree logprobs: position {p}: top ids {e.top_logprobs} against {want}")
    return dict(positions=len(evs), worst_err_over_bound=worst, top_swaps=swaps)


def _tree_tiny(small, p_small) -> dict:
    """The small f32 model on the card: seeded fork bytes equal the clones'
    on a paged engine, and dense chunked ids equal single-shot ids,
    exactly."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    def engine(**kw):
        return Engine(small, p_small, ByteTokenizer(small.vocab_size), device="cuda",
                      engine_cfg=EngineConfig(max_slots=8, max_seq=256, min_prefill_bucket=16,
                                              block_sizes=(8, 1), **kw))

    out = {}
    prompt = [(j * 11) % 250 + 1 for j in range(45)]
    runs = {}
    for fork in (True, False):
        eng = engine(kv_pages=64, kv_page_size=16)
        try:
            reqs = [GenRequest(prompt_ids=prompt, max_new_tokens=16, ignore_eos=True,
                               temperature=0.9, top_k=24, seed=900 + i) for i in range(4)]
            hs = eng.submit_fork(reqs) if fork else [eng.submit(r) for r in reqs]
            runs[fork] = ([[e.token_id for e in h if e.kind == "token"] for h in hs],
                          eng.m_forks)
        finally:
            eng.stop()
    out["fork_equals_clone"] = runs[True][0] == runs[False][0]
    check(out["fork_equals_clone"] and runs[True][1] == 3,
          f"tree tiny f32: fork ids {runs[True]} differ from the clones' {runs[False]}")
    long = [(j * 17) % 250 + 1 for j in range(200)]
    ids = {}
    for chunk in (32, 0):
        eng = engine(prefill_chunk=chunk)
        try:
            ids[chunk] = [e.token_id for e in eng.submit(GenRequest(
                prompt_ids=long, max_new_tokens=16, ignore_eos=True)) if e.kind == "token"]
        finally:
            eng.stop()
    out["dense_chunked_equals_single"] = ids[32] == ids[0]
    check(ids[32] == ids[0], f"tree tiny f32: dense chunked ids {ids[32]} != {ids[0]}")
    return out


def _tree_http() -> dict:
    """The port's server on llama-3.2-1b (4 of 16 layers, the synthetic byte
    tokenizer, the paged engine): chat logprobs (top 5) whole and streamed,
    completions logprobs 3, n 2 of best_of 4, /v1/tokenize, /v1/edits; a
    body deadline_s on the saturated model; a model YAML naming a draft
    model (the same preset, seeded apart: the YAML's speculative knobs reach
    the engine, and a greedy chat is served through its rounds)."""
    import yaml

    msgs = [{"role": "user", "content": "Tell me about the sea."}]
    reqs = [
        ("/v1/chat/completions", {"messages": msgs, "max_tokens": 16, "ignore_eos": True,
                                  "logprobs": True, "top_logprobs": 5}),
        ("/v1/chat/completions", {"messages": msgs, "max_tokens": 16, "ignore_eos": True,
                                  "logprobs": True, "top_logprobs": 5, "stream": True}),
        ("/v1/completions", {"prompt": "Once upon a time", "max_tokens": 16,
                             "ignore_eos": True, "logprobs": 3}),
        ("/v1/chat/completions", {"messages": msgs, "max_tokens": 16, "ignore_eos": True,
                                  "n": 2, "best_of": 4, "temperature": 0.8, "seed": 3}),
        ("/v1/tokenize", {"content": "hello world"}),
        ("/v1/edits", {"instruction": "Fix the spelling", "input": "helo wrld",
                       "max_tokens": 8, "ignore_eos": True}),
    ]
    out: dict = {}
    with tempfile.TemporaryDirectory() as root:
        _write_models_dir(root, tenants=False)
        with open(f"{root}/llama-1b-draft.yaml", "w") as f:
            yaml.safe_dump({**LORA_BASE_YAML, "name": "llama-1b-draft",
                            "draft_model": ONEB_PRESET, "n_draft": 4}, f)
        manager, server, base = _start_server(root)
        try:
            warm = _http(base, "/v1/completions", {"model": "llama-1b", "prompt": "warm up",
                                                   "max_tokens": 2}, time.monotonic())
            check(warm["status"] == 200, f"tree http: warm request {warm}")
            eng = manager.peek("llama-1b").engine
            m0 = eng.metrics()
            _zero_counts()
            results = [_http(base, path, {"model": "llama-1b", **body}, time.monotonic())
                       for path, body in reqs]
            launches = _read_counts()
            m1 = eng.metrics()
            # Every slot busy, then a body deadline: shed from the queue.
            from localai_tpu_torch.engine.engine import GenRequest

            busy = [eng.submit(GenRequest(prompt_ids=[5, 6, 7], max_new_tokens=3000,
                                          ignore_eos=True)) for _ in range(8)]
            for h in busy:
                check(next(iter(h)).kind == "token", "tree http: a busy request failed")
            shed = _http(base, "/v1/chat/completions",
                         {"model": "llama-1b", "messages": msgs, "max_tokens": 4,
                          "deadline_s": 0.5}, time.monotonic())
            eng.cancel_all()
            for h in busy:
                list(h)
            greedy = {"messages": msgs, "max_tokens": 16, "ignore_eos": True,
                      "temperature": 0.0}
            plain = _http(base, "/v1/chat/completions", {"model": "llama-1b", **greedy},
                          time.monotonic())
            draft = _http(base, "/v1/chat/completions", {"model": "llama-1b-draft", **greedy},
                          time.monotonic())
            check(draft["status"] == 200 and plain["status"] == 200,
                  f"tree http: draft_model YAML: {draft}, plain: {plain['status']}")
            deng = manager.peek("llama-1b-draft").engine
            draft["spec"] = {k: v for k, v in deng.metrics().items() if k.startswith("spec_")}
            draft["n_draft"] = deng.n_draft
        finally:
            server.shutdown()
            manager.shutdown()
    replies = []
    for i, ((path, body), res) in enumerate(zip(reqs, results)):
        check(res["status"] == 200, f"tree http: request {i} ({path}) got HTTP "
                                    f"{res['status']}: {res.get('body')}")
        if body.get("stream"):
            check(res["frames"][-1] == "[DONE]", f"tree http: stream {i} did not end in [DONE]")
            chunks = [json.loads(f) for f in res["frames"][:-1]]
            toks = [c["choices"][0] for c in chunks if c["choices"][0].get("logprobs")]
            check(len(toks) == chunks[-1]["usage"]["completion_tokens"] == 16
                  and all(len(c["logprobs"]["content"][0]["top_logprobs"]) == 5 for c in toks),
                  f"tree http: stream {i}: {len(toks)} chunks with logprobs")
            replies.append(dict(path=path, stream=True, tokens=len(toks)))
            continue
        b = res["body"]
        if path == "/v1/tokenize":
            check(b["tokens"] and all(isinstance(t, int) for t in b["tokens"]),
                  f"tree http: tokenize {b}")
            replies.append(dict(path=path, tokens=len(b["tokens"])))
            continue
        if path == "/v1/edits":
            replies.append(dict(path=path, usage=b["usage"]))
            continue
        choices = b["choices"]
        if "best_of" in body:
            check(len(choices) == 2 and b["usage"]["completion_tokens"] == 4 * 16,
                  f"tree http: best_of reply {b['usage']}, {len(choices)} choices")
        elif "messages" in body:
            content = choices[0]["logprobs"]["content"]
            check(len(content) == 16 and all(len(e["top_logprobs"]) == 5
                                             and e["logprob"] <= 0 for e in content),
                  f"tree http: chat logprobs {content[:2]}")
        else:
            lp = choices[0]["logprobs"]
            check(len(lp["tokens"]) == len(lp["token_logprobs"]) == 16
                  and lp["text_offset"] == sorted(lp["text_offset"]),
                  f"tree http: completion logprobs {lp}")
        replies.append(dict(path=path, choices=len(choices), usage=b["usage"]))
    check(m1["fork_branches"] - m0["fork_branches"] == 3,
          f"tree http: best_of 4 forked {m1['fork_branches'] - m0['fork_branches']} branches")
    check(shed["status"] == 500 and "(deadline_s)" in shed["body"],
          f"tree http: deadline on a saturated model: {shed}")
    check(draft["body"]["usage"]["completion_tokens"] == 16
          and draft["n_draft"] == 4 and draft["spec"]["spec_dispatches"] > 0,
          f"tree http: draft_model YAML: {draft}")
    check(launches["flash_prefill"] > 0 and launches["paged_attention"] > 0,
          f"tree http: launches {launches}")
    out.update(replies=replies, launches=launches, shed=shed["body"][:160],
               draft=dict(spec=draft["spec"], content_equals_plain=(
                   draft["body"]["choices"][0]["message"]["content"]
                   == plain["body"]["choices"][0]["message"]["content"])))
    return out


def phase_tree(small, p_small) -> dict:
    """Tree sampling, logprobs, deadlines and dense chunking on
    llama-3.2-1b at full width, 4 of its 16 layers (bf16, seeded random
    weights, the synthetic byte tokenizer): (a) 4 prompts of 200-1200
    tokens, each an n = 4 group of seeded top-p requests, through
    submit_fork on the paged engine after warmup(logprobs=True), then as
    16 clones on a fresh engine: each branch's bytes equal its clone's or
    part at a near tie, 12 forks and no clone fallback, no slot writes a
    page another shares, every page back; (b) best_of 8 on a 1024-token
    prompt: peak pages <= 1.5 x one request's; (c) 8 logprob requests
    (top 5) beside 8 plain ones: the same ids without logprobs (or a near
    tie), every logprob and top 5 against a teacher-forced plain forward,
    and the device ms of a 16-step logprob block against a plain one; (d)
    on 8 busy slots, 4 requests shed by queue_timeout_s, an active deadline,
    then cancel_all; (e) a 3500-token prompt in 512-token chunks over a
    dense cache against its single-shot admission; the small f32 model's
    exact checks; (f) the port's server."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import SyntheticByteTokenizer
    from localai_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _arch_1b()
    L, V = cfg.num_layers, cfg.vocab_size
    params = llama.init_params(cfg, seed=7, device="cuda")
    tok = SyntheticByteTokenizer(V)
    out: dict = {"runs": {}}

    def engine(**kw):
        return Engine(cfg, params, tok, device="cuda", engine_cfg=EngineConfig(
            **{**PAGED_ENGINE, **kw}))

    # (a) fork against clone.
    prompts = _tree_prompts(31, TREE_LENS)
    groups = [(p, 500 + 10 * g) for g, p in enumerate(prompts)]
    fe = engine()
    t0 = time.monotonic()
    fe.warmup(logprobs=True)
    out["warmup_s"] = time.monotonic() - t0
    out["graphs_after_warmup"] = int(fe.metrics()["decode_graphs"])
    bad = _guard_shared_writes(fe)
    fork = _tree_round(fe, groups, fork=True)
    _pool_clean(fe, "tree fork")
    ce = engine()
    ce.warmup()
    clone = _tree_round(ce, groups, fork=False)
    ce.stop()
    del ce
    fm = fork["metrics"]
    check(fm["fork_branches"] == 12 and fm["fork_clone_fallbacks"] == 0,
          f"tree: {fm['fork_branches']} forks, {fm['fork_clone_fallbacks']} clone fallbacks")
    check(not bad, f"tree: writes through shared pages: {bad[:8]}")
    check(fm["decode_graph_captures"] == 0, f"tree: fork run captured graphs: {fm}")
    _tree_launches("tree fork", L, fork)
    _tree_launches("tree clone", L, clone)
    parts = []
    for key, want in clone["ids"].items():
        got = fork["ids"][key]
        if got != want:
            g, i = key
            kw = dict(temperature=0.8, top_p=0.9, seed=groups[g][1] + i)
            part = dict(group=g, branch=i, **_part_gap(cfg, params, prompts[g], want, got, kw))
            parts.append(part)
            check(part["gap"] <= part["bound"],
                  f"tree: a forked branch parts from its clone away from a near tie: {part}")
    out["fork"] = dict(
        equal=sum(fork["ids"][k] == clone["ids"][k] for k in clone["ids"]), parts=parts,
        group_ttft_ms=fork["group_ttft_ms"], clone_group_ttft_ms=clone["group_ttft_ms"],
        admissions=(fm["admissions"], clone["metrics"]["admissions"]),
        chunked_admits=(fm["chunked_admits"], clone["metrics"]["chunked_admits"]),
        prefill_chunks=(fm["prefill_chunks"], clone["metrics"]["prefill_chunks"]),
        prefix_hits=(fm["prefix_hits"], clone["metrics"]["prefix_hits"]),
        launches=(fork["launches"], clone["launches"]), wall_s=(fork["wall_s"],
                                                                clone["wall_s"]))
    out["runs"]["tree_fork"] = {"launches": fork["launches"]}
    out["runs"]["tree_clone"] = {"launches": clone["launches"]}
    # (c) logprobs beside plain requests, on the fork engine.
    lp_prompts = _tree_prompts(37, [300, 450, 600, 750, 900, 1050, 1150, 1250])
    plain_prompts = _tree_prompts(41, [250, 400, 550, 700, 850, 1000, 1100, 1200])

    def lp_round(with_lp: bool) -> dict:
        from localai_tpu_torch.engine.engine import GenRequest as G

        res: dict = {}
        _zero_counts()
        m0 = fe.metrics()
        hs = []
        for i, p in enumerate(lp_prompts):
            kw = dict(temperature=0.8, top_p=0.9, seed=700 + i) if i % 2 else {}
            hs.append((("lp", i), fe.submit(G(prompt_ids=p, max_new_tokens=TREE_NEW,
                                              ignore_eos=True, logprobs=5 if with_lp else 0,
                                              **kw)), kw))
        if with_lp:
            for i, p in enumerate(plain_prompts):
                hs.append((("plain", i), fe.submit(G(prompt_ids=p, max_new_tokens=TREE_NEW,
                                                     ignore_eos=True)), {}))
        for key, h, kw in hs:
            evs = [e for e in h if e.kind == "token"]
            check(len(evs) == TREE_NEW, f"tree logprobs: request {key} ended short")
            res[key] = (evs, kw)
        m1 = fe.metrics()
        return dict(res=res, launches=_read_counts(),
                    metrics={k: m1[k] - m0.get(k, 0.0) for k in m1})

    with_lp, without = lp_round(True), lp_round(False)
    check(with_lp["metrics"]["decode_graph_captures"] == 0,
          f"tree logprobs: captured while serving: {with_lp['metrics']}")
    _tree_launches("tree logprobs", L, with_lp)
    holds, lp_parts = [], []
    for i, p in enumerate(lp_prompts):
        evs, kw = with_lp["res"][("lp", i)]
        check(all(e.logprob is not None and len(e.top_logprobs) == 5 for e in evs),
              f"tree logprobs: request {i} lacks logprobs")
        check(all(e.logprob is None for e in with_lp["res"][("plain", i)][0]),
              "tree logprobs: a plain request carries logprobs")
        holds.append(_teacher_hold(cfg, params, p, evs))
        got = [e.token_id for e in evs]
        want = [e.token_id for e in without["res"][("lp", i)][0]]
        if got != want:
            part = dict(request=i, **_part_gap(cfg, params, p, want, got, kw))
            lp_parts.append(part)
            check(part["gap"] <= part["bound"],
                  f"tree logprobs: ids with logprobs part from without away from a tie: {part}")
    # Device ms a step: one replay of a 16-step block's graph, every slot idle.
    fe._stage_block(np.zeros_like(fe.h_active))
    step_ms = {}
    for variant in ("greedy", "filtered"):
        for lp in (False, True):
            graph = fe._graph_cache[fe._block_key(16, variant, 0, False, lp)][0]
            step_ms[f"{variant}{'_lp' if lp else ''}"] = cuda_time_ms(graph.replay, reps=5,
                                                                      warmup=1) / 16
    out["logprobs"] = dict(held=holds, parts=lp_parts, device_ms_per_step=step_ms,
                           equal=len(lp_prompts) - len(lp_parts))
    out["runs"]["tree_logprobs"] = {"launches": with_lp["launches"]}
    fe.stop()
    del fe
    # (b) best_of 8 pages.
    bo_prompt = _tree_prompts(43, [1024])[0]
    peaks = {}
    for label, n, fork_it in (("one", 1, True), ("best_of_8", 8, True), ("clones_8", 8, False)):
        be = engine(**TREE_BEST_OF)
        try:
            reqs = [GenRequest(prompt_ids=bo_prompt, max_new_tokens=TREE_NEW, ignore_eos=True,
                               temperature=0.8, top_p=0.9, seed=800 + i) for i in range(n)]
            hs = be.submit_fork(reqs) if fork_it else [be.submit(r) for r in reqs]
            for h in hs:
                check(sum(e.kind == "token" for e in h) == TREE_NEW, "tree best_of: short")
            peaks[label] = (int(be.metrics()["kv_pages_peak"]), be.m_forks)
        finally:
            be.stop()
    check(peaks["best_of_8"][1] == 7 and peaks["best_of_8"][0] <= 1.5 * peaks["one"][0],
          f"tree best_of: pages {peaks}")
    out["best_of_pages"] = peaks
    # (d) deadlines on 8 busy slots.
    de = engine(queue_timeout_s=0.5, prefix_cache_entries=0)
    try:
        busy = [de.submit(GenRequest(prompt_ids=[5, 6, 7 + i], max_new_tokens=3000,
                                     ignore_eos=True)) for i in range(8)]
        for h in busy:
            check(next(iter(h)).kind == "token", "tree deadlines: a busy request failed")
        shed = [de.submit(GenRequest(prompt_ids=[9, 9, i], max_new_tokens=8)) for i in range(4)]
        errs = [list(h)[-1] for h in shed]
        want = "request timed out after 0.5s in queue (queue_timeout_s) — server saturated"
        check(all(e.kind == "error" and e.error == want for e in errs)
              and de.metrics()["queue_timeouts"] == 4,
              f"tree deadlines: queue timeouts {[e.error for e in errs]}")
        busy[0].cancel()
        list(busy[0])
        t0 = time.monotonic()
        late = list(de.submit(GenRequest(prompt_ids=[11, 12, 13], max_new_tokens=3000,
                                         ignore_eos=True, deadline_s=1.0)))
        late_s = time.monotonic() - t0
        check(late[-1].kind == "done" and late[-1].finish_reason == "stop"
              and late[-1].completion_tokens < 3000 and de.metrics()["deadline_expired"] == 1,
              f"tree deadlines: active deadline ended {late[-1]}")
        n = de.cancel_all()
        ends = [list(h)[-1].kind for h in busy[1:]]
        check(n >= 7 and ends == ["done"] * 7, f"tree deadlines: cancel_all {n}, {ends}")
        _pool_clean(de, "tree deadlines")
    finally:
        de.stop()
    out["deadlines"] = dict(queue_timeouts=4, active_deadline_s=late_s,
                            active_tokens=late[-1].completion_tokens, cancel_all=n)
    # (e) dense chunking.
    long_prompt = _tree_prompts(47, [3500])[0]
    dense = {}
    for label, chunk in (("chunked", 512), ("single", 0)):
        eng = Engine(cfg, params, tok, device="cuda", engine_cfg=EngineConfig(
            max_slots=2, max_seq=4096, prefill_chunk=chunk, block_sizes=(16, 4, 1)))
        try:
            _zero_counts()
            m0 = eng.metrics()
            t0 = time.monotonic()
            evs = [e for e in eng.submit(GenRequest(prompt_ids=long_prompt,
                                                    max_new_tokens=TREE_NEW, ignore_eos=True))
                   if e.kind == "token"]
            m1 = eng.metrics()
            dense[label] = dict(ids=[e.token_id for e in evs], wall_s=time.monotonic() - t0,
                                launches=_read_counts(),
                                metrics={k: m1[k] - m0.get(k, 0.0) for k in m1})
        finally:
            eng.stop()
        out["runs"][f"tree_dense_{label}"] = {"launches": dense[label]["launches"]}
    dm = dense["chunked"]["metrics"]
    check(dm["chunked_admits"] == 1 and dm["prefill_chunks"] == 7
          and dense["chunked"]["launches"]["flash_prefill"] == 0
          and dense["single"]["launches"]["flash_prefill"] == L,
          f"tree dense chunks: {dm}, launches {dense['chunked']['launches']}")
    dparts = []
    if dense["chunked"]["ids"] != dense["single"]["ids"]:
        dparts.append(_part_gap(cfg, params, long_prompt, dense["single"]["ids"],
                                dense["chunked"]["ids"], {}))
        check(dparts[0]["gap"] <= dparts[0]["bound"],
              f"tree dense chunks: ids part from single-shot away from a tie: {dparts[0]}")
    out["dense_chunks"] = dict(parts=dparts, wall_s={k: v["wall_s"] for k, v in dense.items()},
                               equal=not dparts)
    out["tiny"] = _tree_tiny(small, p_small)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["http"] = _tree_http()
    out["runs"]["tree_http"] = {"launches": out["http"]["launches"]}
    summary = {k: v for k, v in out.items() if k not in ("runs", "http")}
    summary["http"] = out["http"]["replies"]
    summary["http_draft_model"] = out["http"]["draft"]
    log(f"[tree llama-3.2-1b, {ONEB_LAYERS} layers] " + json.dumps(summary))
    out["summary"] = summary
    return out

# --------------------------------------------------------------------------- #
# 21. gguf: a spec-derived GGUF writer, its two files, the served model
# --------------------------------------------------------------------------- #

# The ggml tensor types the writer packs: name -> (type id, weights a block,
# bytes a block), from the public GGUF spec (ggml.h / gguf.md).
GGUF_TYPES = {"F32": (0, 1, 4), "Q8_0": (8, 32, 34), "Q4_K": (12, 256, 144),
              "Q6_K": (14, 256, 210),
              # F32 holding a normal draw x 0.05 (F32 itself holds ones: the norms).
              "F32N": (0, 1, 4)}
# Each quantized type's block layout (ggml-common.h) and the f16 scale fields
# the writer sets over random bytes: every other byte of a block stays
# random, and each scale is drawn (x 0.75-1.25 a block) so a weight's spread
# is about init_params' 0.02. q8_0: w = d·q, q int8 (spread ~74·d); q4_K:
# w = d·sc·q − dmin·m, sc and m 6-bit, q 4-bit (spread ~258·d with dmin =
# 7.5·d, which centres it); q6_K: w = d·sc·(q − 32), sc int8, q 6-bit
# (spread ~1369·d).
GGUF_BLOCKS = {
    "Q8_0": (np.dtype([("d", "<f2"), ("qs", "i1", (32,))]), {"d": 0.02 / 74}),
    "Q4_K": (np.dtype([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
                       ("qs", "u1", (128,))]),
             {"d": 0.02 / 258, "dmin": 7.5 * 0.02 / 258}),
    "Q6_K": (np.dtype([("ql", "u1", (128,)), ("qh", "u1", (64,)), ("scales", "i1", (16,)),
                       ("d", "<f2")]), {"d": 0.02 / 1369}),
}
# llama-3's 256 control tokens follow its 128000 regular ones: these by
# name (offset from the first), the rest <|reserved_special_token_k|>.
LLAMA3_SPECIALS = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 4: "<|finetune_right_pad_id|>",
                   6: "<|start_header_id|>", 7: "<|end_header_id|>", 8: "<|eom_id|>",
                   9: "<|eot_id|>", 10: "<|python_tag|>"}
# Meta-Llama-3-8B-Instruct's published chat template.
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'"
    "+ message['content'] | trim + '<|eot_id|>' %}{% if loop.index0 == 0 %}"
    "{% set content = bos_token + content %}{% endif %}{{ content }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{% endif %}")


def _gguf_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _gguf_kv(key: str, v) -> bytes:
    """One metadata pair: bool, u32, f32, string, or an array of strings or
    i32 (the value types of the GGUF spec)."""
    if isinstance(v, bool):
        body = struct.pack("<IB", 7, v)
    elif isinstance(v, int):
        body = struct.pack("<II", 4, v)
    elif isinstance(v, float):
        body = struct.pack("<If", 6, v)
    elif isinstance(v, str):
        body = struct.pack("<I", 8) + _gguf_str(v)
    elif v and isinstance(v[0], str):
        body = struct.pack("<IIQ", 9, 8, len(v)) + b"".join(_gguf_str(s) for s in v)
    else:
        body = struct.pack("<IIQ", 9, 5, len(v)) + np.asarray(v, "<i4").tobytes()
    return _gguf_str(key) + body


def _gguf_payload(tname: str, n: int, rng) -> bytes:
    """n weights of type tname: F32 ones (the norms), or random blocks with
    their scales set as GGUF_BLOCKS says."""
    if tname == "F32":
        return np.ones(n, "<f4").tobytes()
    if tname == "F32N":
        return (rng.standard_normal(n) * 0.05).astype("<f4").tobytes()
    dt, scales = GGUF_BLOCKS[tname]
    nb = n // GGUF_TYPES[tname][1]
    blocks = np.frombuffer(rng.bytes(nb * dt.itemsize), dt).copy()
    for field, s in scales.items():
        blocks[field] = (s * rng.uniform(0.75, 1.25, nb)).astype(np.float16)
    return blocks.tobytes()


def write_gguf(path: str, kv: dict, tensors: list, seed: int = 0) -> int:
    """A GGUF v3 file: the header, `kv`, the tensor infos of `tensors` =
    [(name, ggml type, ne)] (ne[0] the contiguous in axis), then each
    tensor's payload (from a numpy generator seeded with `seed`) at 32-byte
    alignment, written one tensor at a time. Returns the file's bytes."""
    align = 32
    rng = np.random.default_rng(seed)
    head = struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(kv))
    head += b"".join(_gguf_kv(k, v) for k, v in kv.items())
    offset, sizes = 0, []
    for name, tname, ne in tensors:
        tid, blk, bsz = GGUF_TYPES[tname]
        n = int(np.prod(ne))
        sizes.append(n)
        head += _gguf_str(name) + struct.pack(f"<I{len(ne)}QIQ", len(ne), *ne, tid, offset)
        offset += -(-(n // blk * bsz) // align) * align
    with open(path, "wb") as f:
        f.write(head + b"\0" * (-len(head) % align))
        for (_name, tname, _ne), n in zip(tensors, sizes):
            raw = _gguf_payload(tname, n, rng)
            f.write(raw + b"\0" * (-len(raw) % align))
    return os.path.getsize(path)


def _byte_symbols() -> list[str]:
    """GPT-2's byte-level alphabet in the order llama-3's first 256 ids take
    it: the printable bytes' own characters first, then the others'."""
    bs = list(range(33, 127)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = [chr(c) for c in bs]
    cs += [chr(256 + n) for n in range(256 - len(bs))]
    return cs


def gguf_vocab(n_vocab: int, seed: int = 0) -> tuple[list[str], list[str], list[int]]:
    """A gpt2-type BPE vocabulary of n_vocab tokens in llama-3's layout: the
    256 byte symbols, tokens made by deterministic synthetic merges of
    earlier tokens (older ones drawn more often, at most 16 symbols a
    token), then 256 control tokens. Returns (tokens, merges, token types)."""
    specials, k = [], 0
    for i in range(256):
        name = LLAMA3_SPECIALS.get(i)
        if name is None:
            name, k = f"<|reserved_special_token_{k}|>", k + 1
        specials.append(name)
    regular = n_vocab - 256
    tokens = _byte_symbols()
    seen = set(tokens) | set(specials)
    merges = []
    rng = np.random.default_rng(seed)
    while len(tokens) < regular:
        for u, v in rng.random((4096, 2)) ** 3:
            a, b = tokens[int(u * len(tokens))], tokens[int(v * len(tokens))]
            if len(a) + len(b) <= 16 and a + b not in seen:
                seen.add(a + b)
                tokens.append(a + b)
                merges.append(f"{a} {b}")
                if len(tokens) == regular:
                    break
    return tokens + specials, merges, [1] * regular + [3] * 256


def _gguf_type(plan: str, key: str, layer: int) -> str:
    """The ggml type of a weight in a file laid out as `plan`: "q8_0", or
    "q4_k_m" (llama.cpp's Q4_K_M: q4_K, with attn_v and ffn_down in q6_K
    in alternate layers, so those two keys mix types, and q6_K embeddings
    and head)."""
    if plan == "q8_0":
        return "Q8_0"
    if key in ("token_embd", "output") or (key in ("attn_v", "ffn_down") and layer % 2 == 0):
        return "Q6_K"
    return "Q4_K"


def write_gguf_model(path: str, cfg, layers: int, plan: str, seed: int = 0) -> int:
    """A llama-family GGUF at cfg's widths with `layers` decoder layers,
    laid out as `plan`, with llama-3's tokenizer metadata (gguf_vocab, the
    llama-bpe pre-tokenizer, bos / eos, chat template) and its rope scaling;
    an untied cfg gets an `output.weight`. Returns the file's bytes."""
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Hd, Kd = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    tokens, merges, types = gguf_vocab(V, seed)
    kv = {"general.architecture": "llama", "general.name": cfg.name, "llama.block_count": layers,
          "llama.context_length": cfg.max_position, "llama.embedding_length": D,
          "llama.feed_forward_length": F, "llama.attention.head_count": cfg.num_heads,
          "llama.attention.head_count_kv": cfg.num_kv_heads,
          "llama.attention.layer_norm_rms_epsilon": float(cfg.rms_eps),
          "llama.rope.freq_base": float(cfg.rope_theta),
          "llama.rope.dimension_count": cfg.head_dim_, "llama.vocab_size": V,
          "tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama-bpe",
          "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types,
          "tokenizer.ggml.merges": merges, "tokenizer.ggml.bos_token_id": V - 256,
          "tokenizer.ggml.eos_token_id": V - 256 + 9, "tokenizer.ggml.add_bos_token": True,
          "tokenizer.chat_template": LLAMA3_CHAT_TEMPLATE}
    if cfg.rope_scaling == "llama3":
        kv["llama.rope.scaling.factor"] = float(cfg.rope_scaling_factor)
        kv["llama.rope.scaling.original_context_length"] = cfg.rope_original_max_position
    tensors = [("token_embd.weight", _gguf_type(plan, "token_embd", 0), (D, V))]
    for i in range(layers):
        for key, ne in (("attn_norm", (D,)), ("attn_q", (D, Hd)), ("attn_k", (D, Kd)),
                        ("attn_v", (D, Kd)), ("attn_output", (Hd, D)), ("ffn_norm", (D,)),
                        ("ffn_gate", (D, F)), ("ffn_up", (D, F)), ("ffn_down", (F, D))):
            tname = "F32" if len(ne) == 1 else _gguf_type(plan, key, i)
            tensors.append((f"blk.{i}.{key}.weight", tname, ne))
    tensors.append(("output_norm.weight", "F32", (D,)))
    if not cfg.tie_embeddings:
        tensors.append(("output.weight", _gguf_type(plan, "output", 0), (D, V)))
    return write_gguf(path, kv, tensors, seed)


def _deepseek_gguf_type(key: str, layer: int) -> str:
    """The ggml type of a weight in the deepseek2 file of phase
    gguf_deepseek, mixed as a Q4_K_M file mixes them: routed experts in
    q4_K (gate / up; q8_0 in every third layer) with ffn_down_exps in q8_0
    (its 1408-wide rows are no whole number of K-quant blocks, as the
    dense ffn_down's 10944 are not), attention in q6_K / q8_0, the shared
    experts and the dense MLP in q4_K / q6_K, embeddings and head in
    q6_K, norms and the router in F32."""
    if key in ("ffn_down_exps", "ffn_down", "attn_kv_a_mqa", "attn_output"):
        return "Q8_0"
    if key in ("ffn_gate_exps", "ffn_up_exps"):
        return "Q8_0" if layer % 3 == 2 else "Q4_K"
    if key in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_gate", "ffn_up"):
        return "Q4_K"
    return "Q6_K"


def write_gguf_deepseek(path: str, cfg, layers: int, types=_deepseek_gguf_type,
                        seed: int = 0, vocab: bool = True) -> int:
    """A DeepSeek GGUF in llama.cpp's deepseek2 layout at cfg's widths with
    `layers` blocks (the first cfg.first_k_dense dense, the rest MoE with
    fused `_exps` stacks and `_shexp` shared experts; attn_q or the q-lora
    pair attn_q_a / attn_q_b; exp_probs_b when cfg.router_bias), each
    weight of ggml type types(key, layer) ("F32N": a random F32 draw), with
    deepseek2 metadata (cfg's rope, router and MLA settings) and, when
    `vocab`, gguf_vocab's tokenizer. Returns the file's bytes."""
    D, V, E = cfg.hidden_size, cfg.vocab_size, cfg.num_experts
    H, r, rot = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    n, vd, qr = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.q_lora_rank
    Fm, kd = cfg.moe_inter_size, cfg.first_k_dense
    a = "deepseek2"
    kv = {"general.architecture": a, "general.name": cfg.name, f"{a}.block_count": layers,
          f"{a}.context_length": cfg.max_position, f"{a}.embedding_length": D,
          f"{a}.feed_forward_length": cfg.intermediate_size,
          f"{a}.attention.head_count": H, f"{a}.attention.head_count_kv": H,
          f"{a}.attention.layer_norm_rms_epsilon": float(cfg.rms_eps),
          f"{a}.attention.kv_lora_rank": r, f"{a}.attention.key_length": n + rot,
          f"{a}.attention.value_length": vd, f"{a}.rope.dimension_count": rot,
          f"{a}.rope.freq_base": float(cfg.rope_theta), f"{a}.vocab_size": V,
          f"{a}.expert_count": E, f"{a}.expert_used_count": cfg.num_experts_per_token,
          f"{a}.expert_shared_count": cfg.n_shared_experts,
          f"{a}.expert_feed_forward_length": Fm,
          f"{a}.expert_weights_scale": float(cfg.routed_scaling_factor),
          f"{a}.expert_weights_norm": bool(cfg.norm_topk_prob),
          f"{a}.expert_gating_func": 2 if cfg.scoring_func == "sigmoid" else 1,
          f"{a}.expert_group_count": cfg.n_group, f"{a}.expert_group_used_count": cfg.topk_group,
          f"{a}.leading_dense_block_count": kd}
    if qr:
        kv[f"{a}.attention.q_lora_rank"] = qr
    if vocab:
        tokens, merges, ttypes = gguf_vocab(V, seed)
        kv.update({"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama-bpe",
                   "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": ttypes,
                   "tokenizer.ggml.merges": merges, "tokenizer.ggml.bos_token_id": V - 256,
                   "tokenizer.ggml.eos_token_id": V - 256 + 9,
                   "tokenizer.ggml.add_bos_token": True,
                   "tokenizer.chat_template": LLAMA3_CHAT_TEMPLATE})
    tensors = [("token_embd.weight", types("token_embd", 0), (D, V))]
    for i in range(layers):
        mats = [("attn_norm", (D,)), ("ffn_norm", (D,)), ("attn_kv_a_norm", (r,))]
        if qr:
            mats += [("attn_q_a", (D, qr)), ("attn_q_a_norm", (qr,)),
                     ("attn_q_b", (qr, H * (n + rot)))]
        else:
            mats.append(("attn_q", (D, H * (n + rot))))
        mats += [("attn_kv_a_mqa", (D, r + rot)), ("attn_kv_b", (r, H * (n + vd))),
                 ("attn_output", (H * vd, D))]
        if i < kd:
            F = cfg.intermediate_size
            mats += [("ffn_gate", (D, F)), ("ffn_up", (D, F)), ("ffn_down", (F, D))]
        else:
            S = Fm * cfg.n_shared_experts
            mats += [("ffn_gate_inp", (D, E)), ("ffn_gate_exps", (D, Fm, E)),
                     ("ffn_up_exps", (D, Fm, E)), ("ffn_down_exps", (Fm, D, E))]
            if S:
                mats += [("ffn_gate_shexp", (D, S)), ("ffn_up_shexp", (D, S)),
                         ("ffn_down_shexp", (S, D))]
        for key, ne in mats:
            tname = "F32" if len(ne) == 1 else types(key, i)
            if key == "ffn_gate_inp" and tname not in ("F32", "F32N"):
                tname = "F32N"  # llama.cpp keeps the router in F32
            tensors.append((f"blk.{i}.{key}.weight", tname, ne))
        if i >= kd and cfg.router_bias:
            tensors.append((f"blk.{i}.exp_probs_b.bias", "F32N", (E,)))
    tensors.append(("output_norm.weight", "F32", (D,)))
    if not cfg.tie_embeddings:
        tensors.append(("output.weight", types("output", 0), (D, V)))
    return write_gguf(path, kv, tensors, seed)


# The two files: llama-3.2-1b as a Q4_K_M file (tied embeddings, as
# published), 4 of its 16 layers, and llama-3-8b as a Q8_0 file with an
# untied output.weight, 2 of its 32 layers (cut for time: 16 and 8 until
# the deepseek phases joined the run, 16 and 4 until the observe phase did,
# the 1b's 8 until phases 27-29 did).
GGUF_FILES = (("llama-3.2-1b", 4, "q4_k_m"), ("llama-3-8b", 2, "q8_0"))
GGUF_YAML = {"context_size": 4096, "max_slots": 8, "kv_pages": 256, "kv_page_size": 128,
             "prefill_chunk": 512, "max_tokens": 64,
             "template": {"use_tokenizer_template": True}}
GGUF_CHAT_CHARS = [120, 400, 900, 1600, 2400, 3200, 250, 1200]


def _gguf_text(n_chars: int, seed: int) -> str:
    """Deterministic text of n_chars: random words, digits, punctuation,
    contractions, non-ASCII (Greek, Cyrillic, CJK, an emoji), tabs and
    newlines."""
    import random

    rnd = random.Random(seed)
    pool = ["the", "model", "serves", "tokens", "GGUF", "llama", "Ωμέγα", "мир", "你好", "🙂",
            "don't", "we've", "x*2", "(a, b)", "123", "4567", "\n", "\t", "  ", "#"]
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGH0123456789.,;!?'"
    words, n = [], 0
    while n < n_chars:
        w = (rnd.choice(pool) if rnd.random() < 0.4
             else "".join(rnd.choice(letters) for _ in range(rnd.randint(1, 9))))
        words.append(w)
        n += len(w) + 1
    return " ".join(words)[:n_chars]


def _hold_gguf_layer(label: str, tree: dict, plan: str, gen: torch.Generator) -> list[dict]:
    """B3 on every quantized projection of layer 0 as the loader repacked
    it: 8 bf16 rows against its plain version (_hold_b3's bounds and
    times), and 8 f32 rows against the dequantize-then-matmul route (the
    f32 bound of the B3 rows, 1e-4 x max|out|)."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops.quant_matmul import qmm, qmm_plain, qmm_plan

    rows = []
    gkeys = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
             "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down"}
    for key in gkeys:
        w = {k: torch.from_numpy(np.ascontiguousarray(v[0])).cuda()
             for k, v in tree["layers"][key].items()}
        form = "g4" if "g4" in w else "gq"
        G, _r, n_out = w[form].shape
        n_in = G * 32
        wb = quant.dequantize_tensor(w).to(torch.bfloat16)
        x = torch.randn(8, n_in, generator=gen, device="cuda").to(torch.bfloat16)
        plan_b3 = qmm_plan(n_in, n_out, 8, kernels.sm_count(x.device))._asdict()
        row = _hold_b3(f"quant_matmul gguf {label}", lambda v: qmm(v, w),
                       lambda v: qmm_plain(v, w), x, lambda: torch.matmul(x, wb),
                       lambda v: quant.matmul(v, w),
                       _qmm_work("int4" if form == "g4" else "grouped_int8", 8, n_in, n_out, 2),
                       plan_b3, shape=[8, n_in, n_out], form=form, key=key,
                       ggml_type=_gguf_type(plan, gkeys[key], 0))
        x32 = x.float()
        out = qmm(x32, w)
        with _dequant_route():
            ref = quant.matmul(x32, w)
        err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
        row.update(dequant_route_f32_err=err, dequant_route_f32_max=scale)
        log(f"[gguf {label} {key} {form}] f32 x: kernel vs dequantize-then-matmul route "
            f"max_abs_err={err:.3e} (max |out| {scale:.3e})")
        check(err <= 1e-4 * scale, f"gguf {label} {key}: the f32 kernel differs from the "
                                   f"dequant route by {err} (max {scale})")
        rows.append(row)
        del w, wb
    return rows


def _hold_gguf_head(tree: dict, gen: torch.Generator) -> dict:
    """B4 on the int8 head the loader made of output.weight: 8 bf16 rows
    against its plain version (_hold_unembed), and 8 f32 rows against the
    dequantize-then-matmul route (1e-4 x max|logit|)."""
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops.quant_matmul import qunembed

    head = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in tree["lm_head"].items()}
    head_bf16 = (head["q"].float() * head["s"]).to(torch.bfloat16)
    h = torch.randn(8, head["q"].shape[1], generator=gen, device="cuda").to(torch.bfloat16)
    row = _hold_unembed(h, head, head_bf16)
    out = qunembed(h.float(), head)
    with _dequant_route():
        ref = quant.unembed_matmul(h.float(), head)
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    row.update(dequant_route_f32_err=err, dequant_route_f32_max=scale)
    log(f"[gguf head] f32 h: kernel vs dequantize-then-matmul route max_abs_err={err:.3e} "
        f"(max |logit| {scale:.3e})")
    check(err <= 1e-4 * scale, f"gguf head: the f32 kernel differs from the dequant route by "
                               f"{err} (max {scale})")
    return row


def _hold_gguf_tokenizer(tok, load_s: float) -> dict:
    """The synthesized tokenizer as the server loaded it (`load_s`, the
    model's whole load): the native BPE engine is on, and its ids equal the
    HF tokenizer's on the canaries, a chat prompt with control tokens and a
    20,000-character text; host µs a character of each."""
    from localai_tpu_torch.engine.bpe_fast import _CANARIES

    check(tok.native_bpe, "gguf: the native BPE encoder is off for the synthesized tokenizer")
    big = _gguf_text(20000, 17)
    chat = tok.apply_chat_template([{"role": "user", "content": _gguf_text(300, 5)}])
    for text in [*_CANARIES, chat, big]:
        got, want = tok.encode(text), tok._tok.encode(text, add_special_tokens=False)
        check(got == want, f"gguf: native BPE ids differ from the HF tokenizer's on "
                           f"{text[:40]!r}: {got[:8]} != {want[:8]}")
    tok._fast._piece_cache.clear()
    t0 = time.perf_counter()
    ids = tok._fast.encode(big)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok._tok.encode(big, add_special_tokens=False)
    hf_s = time.perf_counter() - t0
    out = dict(vocab=tok.vocab_size, load_s=load_s, chars=len(big), ids=len(ids),
               native_us_per_char=native_s / len(big) * 1e6,
               hf_us_per_char=hf_s / len(big) * 1e6, chat_prompt_ids=len(tok.encode(chat)))
    log("[gguf tokenizer] " + json.dumps(out))
    return out


def _dense_of(params: dict) -> dict:
    """The dequantized dense tree of a quantized one: each quantized leaf
    back to [.., in, out] (the head [V, D]) in bf16, on the card."""
    from localai_tpu_torch.models import quant

    def deq(w):
        return quant.dequantize_tensor(w).to(torch.bfloat16) if quant.is_quantized(w) else w

    out = {k: deq(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: deq(v) for k, v in params["layers"].items()}
    return out


def _gguf_against_dense(label: str, cfg, params: dict, plens: list[int], new: int,
                        probe=None) -> dict:
    """The GGUF engine (params as loaded) against an engine on the
    dequantized dense bf16 tree: the same requests (_serve: half greedy,
    half seeded), each greedy request's ids equal or parting at a near tie
    (_part_gap's bound on the dense model's logits). Returns the GGUF run,
    with `probe(engine)`'s result after it as "probe" when given."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    def engine(p):
        return Engine(cfg, p, ByteTokenizer(cfg.vocab_size), device="cuda",
                      engine_cfg=EngineConfig(**PAGED_ENGINE))

    eng = engine(params)
    run = _serve(eng, plens, max_new=new, keep_ids=True)
    if probe is not None:
        run["probe"] = probe(eng)
    del eng
    dense = _dense_of(params)
    ref = _serve(engine(dense), plens, max_new=new, keep_ids=True)
    parts = []
    prompts = _serve_prompts(plens)
    for i in range(0, len(plens), 2):  # the greedy requests
        want, got = ref["ids"][i], run["ids"][i]
        if want != got:
            gap = _part_gap(cfg, dense, prompts[i], want, got, {})
            check(gap["gap"] <= gap["bound"], f"gguf {label}: greedy request {i} parts from "
                                              f"the dense tree's at {gap}")
            parts.append(gap)
    run["greedy_vs_dense"] = dict(requests=len(range(0, len(plens), 2)), parted=parts,
                                  dense_weight_bytes=ref["weight_bytes"])
    del dense
    torch.cuda.empty_cache()
    return run


def _form_bytes(params: dict) -> dict:
    """Device bytes a weight of each grouped form (payload, scales, zero
    points) over the layer stacks, and the weights of each."""
    acc = {}
    for w in params["layers"].values():
        if isinstance(w, dict) and ("g4" in w or "gq" in w):
            form = "g4" if "g4" in w else "gq"
            n = w[form].numel() * (2 if form == "g4" else 1)
            b = sum(t.numel() * t.element_size() for t in w.values())
            tot = acc.setdefault(form, [0, 0])
            tot[0], tot[1] = tot[0] + b, tot[1] + n
    return {f: dict(weights=n, bytes=b, bytes_per_weight=b / n) for f, (b, n) in acc.items()}


def phase_gguf(gen: torch.Generator) -> dict:
    """GGUF checkpoints through the port: the two files written here, each
    parsed and repacked (timed) and held layer by layer (B3 in its g4 and
    gq forms, B4 on the 8b head); the 1b file's synthesized tokenizer
    through the native BPE engine; the 1b file served by the port's HTTP
    server from a YAML `model: <file>.gguf` (8 concurrent chats, half
    streamed, half greedy, 64 tokens; B3 launched in both forms); the 8b
    file through Engine.submit (B4 on the path); each against its
    dequantized dense tree."""
    import yaml

    from localai_tpu_torch.engine import gguf as load_gguf_module
    from localai_tpu_torch.engine.gguf import load_gguf_checkpoint
    from localai_tpu_torch.engine.weights import params_from_numpy
    from localai_tpu_torch.models import get_arch

    out = {"files": {}}
    root = tempfile.mkdtemp(prefix="gguf-")
    try:
        trees = {}
        for name, layers, plan in GGUF_FILES:
            cfg = get_arch(name)
            path = f"{root}/{name}-{plan}.gguf"
            t0 = time.monotonic()
            nbytes = write_gguf_model(path, cfg, layers, plan)
            write_s = time.monotonic() - t0
            t0 = time.monotonic()
            arch, tree, tok_dir = load_gguf_checkpoint(path)
            parse_s = time.monotonic() - t0
            widths = ("vocab_size", "hidden_size", "intermediate_size", "num_heads",
                      "num_kv_heads", "head_dim_", "rope_theta", "rope_scaling",
                      "rope_scaling_factor", "tie_embeddings")
            check(all(getattr(arch, k) == getattr(cfg, k) for k in widths)
                  and arch.num_layers == layers,
                  f"gguf {name}: the file's arch {arch} is not {name}'s widths")
            trees[name] = (arch, tree, tok_dir, path)
            out["files"][name] = dict(layers=layers, plan=plan, file_bytes=nbytes,
                                      write_s=write_s, parse_and_repack_s=parse_s,
                                      tokenizer_dir=tok_dir is not None)
            log(f"[gguf {name} {plan}] " + json.dumps(out["files"][name]))
            out.setdefault("b3_rows", []).extend(_hold_gguf_layer(name, tree, plan, gen))
        out["b4_row"] = _hold_gguf_head(trees["llama-3-8b"][1], gen)

        # The 1b file served over HTTP from its YAML.
        with open(f"{root}/gguf-1b.yaml", "w") as f:
            yaml.safe_dump({"name": "gguf-1b", "model": "llama-3.2-1b-q4_k_m.gguf", **GGUF_YAML},
                           f)
        manager, server, base = _start_server(root)
        try:
            # The manager's loader is handed the parse above (the file is the
            # same): load_s is the card, the tokenizer and the engine.
            t0 = time.monotonic()
            parsed = trees["llama-3.2-1b"][:3]
            with swapped(load_gguf_module, "load_gguf_checkpoint", lambda _p: parsed):
                eng = manager.get("gguf-1b").engine
            load_s = time.monotonic() - t0
            check(eng.tokenizer.native_bpe, "gguf-1b: the served tokenizer is not native BPE")
            out["tokenizer"] = _hold_gguf_tokenizer(eng.tokenizer, load_s)
            t0 = time.monotonic()
            eng.warmup()  # every decode-block shape captured before traffic
            warmup_s = time.monotonic() - t0
            warm = [("/v1/chat/completions", "gguf-1b",
                     {"model": "gguf-1b", "max_tokens": 4, "ignore_eos": True,
                      "messages": [{"role": "user", "content": "warm up"}]})]
            results, _ = _http_batch(base, warm)
            check(results[0]["status"] == 200, f"gguf-1b warm request: {results[0]}")
            reqs = []
            for i, n in enumerate(GGUF_CHAT_CHARS):
                greedy = i % 2 == 0
                reqs.append(("/v1/chat/completions", "gguf-1b", {
                    "model": "gguf-1b", "max_tokens": 64, "ignore_eos": True,
                    "stream": i % 4 in (1, 2), "temperature": 0.0 if greedy else 0.8,
                    "top_p": 1.0 if greedy else 0.9, "seed": 100 + i,
                    "messages": [{"role": "user", "content": _gguf_text(n, 100 + i)}]}))
            m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
            _zero_counts()
            results, wall = _http_batch(base, reqs)
            n = _read_counts()
            m1 = eng.metrics()
            _texts, ttfts = _check_http_results("gguf-1b", reqs, results)
            steps = int(m1["decode_steps"] - m0["decode_steps"])
            _check_graphs("gguf-1b", {k: int(m1[k] - m0[k]) for k in (
                "decode_blocks", "decode_graph_captures", "decode_graph_replays")})
            check(n["quant_matmul_g4"] > 0 and n["quant_matmul_gq"] > 0
                  and n["quant_matmul_q"] == 0 and n["flash_prefill"] > 0
                  and n["paged_attention"] > 0,
                  f"gguf-1b: the served path missed a kernel or a form: {n}")
            # Every decode step runs the 7 products of each layer through B3:
            # wv and w_down in gq, the other 5 in g4.
            L = eng.cfg.num_layers
            check(n["quant_matmul_gq"] >= 2 * L * steps and n["quant_matmul_g4"] >= 5 * L * steps,
                  f"gguf-1b: B3 launches {n} for {steps} decode steps x {L} layers")
            dt_s = eng._decode_time - dt0
            out["http"] = dict(requests=len(reqs), wall_s=wall, load_s=load_s, warmup_s=warmup_s,
                               ttft_ms_p50=statistics.median(ttfts) * 1e3,
                               ttft_ms_max=max(ttfts) * 1e3,
                               decode_tok_s=(eng._decode_tokens - tok0) / dt_s,
                               decode_steps=steps,
                               admissions=int(m1["admissions"] - m0["admissions"]),
                               prefill_chunks=int(m1["prefill_chunks"] - m0["prefill_chunks"]),
                               weight_bytes=int(m1["weight_bytes"]),
                               file_bytes=out["files"]["llama-3.2-1b"]["file_bytes"],
                               forms=_form_bytes(eng.params), launches=n)
            log("[gguf llama-3.2-1b http] " + json.dumps(out["http"]))
        finally:
            server.shutdown()
            manager.shutdown()
        torch.cuda.empty_cache()

        # Each file's engine against its dequantized dense tree; the 8b run
        # is the path with B4 (an untied head).
        for name, layers, plan in GGUF_FILES:
            arch, tree = trees.pop(name)[:2]
            params = params_from_numpy(arch, tree, device="cuda")
            del tree
            run = _gguf_against_dense(name, arch, params, [20, 100, 300, 700, 1500, 20, 100, 300],
                                      32)
            n = run["launches"]
            form = "g4" if plan == "q4_k_m" else "gq"
            check(n[f"quant_matmul_{form}"] > 0 and n["quant_matmul_gq"] > 0
                  and n["flash_prefill"] > 0 and n["paged_attention"] > 0,
                  f"gguf {name} engine: a kernel or a form did not run: {n}")
            check(arch.tie_embeddings or n["quant_unembed"] > 0,
                  f"gguf {name} engine: B4 did not run on the untied head: {n}")
            _check_graphs(f"gguf {name}", run)
            run["forms"] = _form_bytes(params)
            run.pop("ids")
            out[f"engine_{name}"] = run
            log(f"[gguf {name} engine] " + json.dumps(run))
            del params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gq = next(r for r in out["b3_rows"] if r["form"] == "gq" and r["shape"] == [8, 4096, 14336])
    out["summary"] = dict(
        files={k: {kk: v[kk] for kk in ("file_bytes", "parse_and_repack_s")}
               for k, v in out["files"].items()},
        http={k: out["http"][k] for k in ("ttft_ms_p50", "decode_tok_s", "weight_bytes",
                                          "file_bytes", "forms")},
        gq_8b_gate=_compact(gq, ("shape", "ms", "plain_ms", "bf16_ms", "dequant_ms", "bound_ms",
                                 "bound_frac", "max_abs_err")),
        tokenizer={k: out["tokenizer"][k] for k in ("native_us_per_char", "hf_us_per_char")},
        greedy_vs_dense={k: len(out[f"engine_{k}"]["greedy_vs_dense"]["parted"])
                         for k, _l, _p in GGUF_FILES})
    log("[gguf summary] " + json.dumps(out["summary"]))
    return out



def _compact(row: dict, keys) -> dict:
    return {k: row[k] for k in keys}


# --------------------------------------------------------------------------- #
# deepseek: B2's latent form and deepseek-v2-lite at full width and depth
# --------------------------------------------------------------------------- #

def _hold_latent(label: str, g, B, T, D, page, MP, dt, limits, kv_scale=None, hier_span=0,
                 sink=0, swin=0) -> dict:
    """B2's latent form (K = 1, the pool passed as K and V) against its
    plain version on the card at one shape: QR = 16 heads x T tokens a
    slot (4 heads at D = 48, tiny-mla's), query positions limit + t. Every
    output must agree within the B2 tolerance and be bit-identical when
    launched again and for each slot alone."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.models.llama import kv_cast
    from localai_tpu_torch.ops.paged_flash import (
        paged_partials_plain, paged_partials_rows, plan_for)

    tol = 2e-4
    G = 16 if D == 576 else 4
    QR = G * T
    P = B * MP + 1
    lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
    qr = torch.randn(B, 1, QR, D, generator=g, device="cuda") / D**0.5
    pool = torch.randn(P, page, 1, D, generator=g, device="cuda")
    if kv_scale is not None:
        kv_scale = torch.full((2, 1), float(kv_scale), device="cuda")
        pool = pool / kv_scale[0][:, None]
    pool = kv_cast(pool, dt)
    flat = torch.randperm(P - 1, generator=g, device="cuda")[: B * MP]
    flat = flat.reshape(B, MP).to(torch.int32).contiguous()
    table = _hier_of(flat, hier_span, P - 1) if hier_span else flat
    qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
    args = (qr, qpos, pool, pool, table, lim, 0.0, 0, kv_scale, sink, swin)
    acc, m, l = paged_partials_rows(*args)
    torch.cuda.synchronize()
    racc, rm, rl = paged_partials_plain(*args)
    o_err = (acc / l.clamp(min=1e-30)[..., None]
             - racc / rl.clamp(min=1e-30)[..., None]).abs().max().item()
    m_err = (m - rm).abs().max().item()
    l_rel = ((l - rl).abs() / rl).max().item()
    again = paged_partials_rows(*args)
    repeat_equal = all(torch.equal(a, b) for a, b in zip((acc, m, l), again))

    def slot(b):
        tb = (table[0][b:b + 1], table[1]) if hier_span else table[b:b + 1]
        return paged_partials_rows(qr[b:b + 1], qpos[b:b + 1], pool, pool, tb, lim[b:b + 1],
                                   0.0, 0, kv_scale, sink, swin)

    alone_equal = all(all(torch.equal(a[b:b + 1], x) for a, x in zip((acc, m, l), slot(b)))
                      for b in range(B))
    plan = plan_for(qr, pool, table, kernels.sm_count(torch.device("cuda")))
    ms = cuda_time_cold_ms(lambda: paged_partials_rows(*args), 20)
    plain_ms = cuda_time_cold_ms(lambda: paged_partials_plain(*args), 2)
    flops, nbytes = _paged_work(qpos.cpu().numpy(), np.asarray(limits), 1, D, MP, page,
                                dt.itemsize, 0, sink, swin, hier_span, latent=True)
    nbytes += 0 if kv_scale is None else 8
    rate = torch.float32 if dt == torch.float32 else torch.bfloat16
    t_ops, t_bytes = flops / PEAK_FLOPS[rate] * 1e3, nbytes / PEAK_BYTES * 1e3
    row = dict(shape=label, B=B, H=G, K=1, QR=QR, D=D, page=page, MP=MP,
               pool_dtype=str(dt).replace("torch.", ""), limits=limits,
               kv_scale=None if kv_scale is None else kv_scale.tolist(),
               table="hier" if hier_span else "flat", sink=sink, swin=swin,
               max_abs_err=o_err, m_err=m_err, l_rel_err=l_rel, tol=tol,
               repeat_equal=repeat_equal, alone_equal=alone_equal,
               ok=max(o_err, m_err, l_rel) <= tol and repeat_equal and alone_equal
               and bool(torch.isfinite(acc).all()),
               plan={**plan._asdict(), "grid": [plan.splits, -(-QR // plan.row_tile), B]},
               ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_ops, t_bytes), bound_frac=max(t_ops, t_bytes) / ms,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"[kernel paged_attention latent] {json.dumps(row)}")
    check(row["ok"], f"B2's latent form disagrees with its plain version at {label} "
                     f"D={D} {row['pool_dtype']}: acc/l err {o_err}, m err {m_err}, l rel err "
                     f"{l_rel} (tol {tol}), repeat bit-identical={repeat_equal}, slots alone "
                     f"bit-identical={alone_equal}")
    return row


def phase_latent_kernels() -> list[dict]:
    """B2's latent form at deepseek-v2-lite's shapes (K = 1, D = 576, 16
    heads, pages of 128, a 4096-row table): decode over 8 slots with limits
    from 1 to 4096, several at split edges (multiples of 128 rows) or one
    row either side; a 6-token verify (QR = 96); a 512-token chunk at
    offset 1024 (QR = 8192); the decode and the chunk again on e4m3 pools
    stored at kv_scale 2; a hierarchical table (table pages of 16 entries)
    under the sink 128 + window 4096 skip at a 16384-row limit; and
    tiny-mla's f32 form at D = 48 (decode and a 3-token verify)."""
    g = torch.Generator(device="cuda").manual_seed(19)
    edges = [4096, 1, 128, 127, 129, 2048, 3001, 256]
    ragged = [4096, 1024, 640, 1, 2900, 128, 1025, 3500]
    return [
        _hold_latent("decode", g, 8, 1, 576, 128, 32, torch.bfloat16, edges),
        _hold_latent("verify_t6", g, 8, 6, 576, 128, 32, torch.bfloat16, ragged),
        _hold_latent("prefill_chunk", g, 1, 512, 576, 128, 32, torch.bfloat16, [1024]),
        _hold_latent("decode_fp8", g, 8, 1, 576, 128, 32, torch.float8_e4m3fn, edges,
                     kv_scale=2.0),
        _hold_latent("prefill_chunk_fp8", g, 1, 512, 576, 128, 32, torch.float8_e4m3fn,
                     [1024], kv_scale=2.0),
        _hold_latent("decode_hier_sink_window", g, 2, 1, 576, 128, 128, torch.bfloat16,
                     [16384, 5000], hier_span=16, sink=128, swin=4096),
        _hold_latent("decode_f32_d48", g, 4, 1, 48, 16, 16, torch.float32, [256, 1, 100, 17]),
        _hold_latent("verify_f32_d48", g, 4, 3, 48, 16, 16, torch.float32, [200, 16, 3, 250]),
    ]


# The shared prefix of the deepseek follow-up request: request 5's first
# 1536 tokens (3 pages of 128 x 4 = 12 pages), then a tail of its own.
DEEPSEEK_SHARED = 1536
DEEPSEEK_TAIL = 400
DEEPSEEK_INT4_LAYERS = 8  # of 27: the int4 run is cut for time
# of 27: the bf16 run is cut for time since the observe phase joined the run
# (its one dense layer and 13 of its MoE layers; every layer's shapes kept).
# At 8 layers the dense engine's ids parted from the paged engine's beyond a
# near tie on one sampled request (ROADMAP Queue C), so the cut stays at 14.
DEEPSEEK_LAYERS = 14
DEEPSEEK_PRESET = "deepseek-v2-lite-14l"  # deepseek_http's YAML names it
DEEPSEEK_NEW = 32  # tokens a request of the bf16 runs (64 elsewhere): the run's time
# The paged chunks' prefill logits (absorbed MLA through B2's latent form)
# may sit at most this many times farther from the dense prefill's
# (full-rank MLA) than the dense prefill of the same prompt in a batch of
# two does (bf16 rounding alone). On an H100 the two read 4.6 % and 2.3 %
# of the largest |logit| (a ratio of 2.0); a few per cent of error in the
# absorbed path's scale fold, kv_scale or unlatent would exceed 3x.
DEEPSEEK_PAGED_SPREAD = 3.0


def _deepseek_follow() -> list[list[int]]:
    """The follow-up prompt: request 5's first DEEPSEEK_SHARED tokens and a
    new tail, so its admission hits the prefix cache and its tail's chunk
    walks the shared latent pages through B2's latent form."""
    gen = torch.Generator().manual_seed(31)
    shared = _serve_prompts(PAGED_PROMPTS)[5][:DEEPSEEK_SHARED]
    return [shared + torch.randint(0, 256, (DEEPSEEK_TAIL,), generator=gen).tolist()]


def _check_deepseek_launches(label: str, cfg, out: dict, quantized: bool) -> None:
    """The launch identities of a deepseek paged engine run: B2's latent
    form once a layer a decode step and a prefill chunk (admissions of at
    most one chunk take the full-rank dense prefill, no B2); with quantized
    weights also B3 (6 two-dimensional products a layer a pass: the q,
    latent and output projections, and the dense MLP or the shared
    experts), its expert form (3 a MoE layer a pass) and B4 (each pass
    with logits)."""
    L, n = cfg.num_layers, out["launches"]
    steps, passes = out["decode_steps"], out["admissions"] + out["prefill_chunks"]
    check(n["paged_attention_latent"] == L * (steps + out["prefill_chunks"])
          and n["paged_attention"] == 0 and n["flash_prefill"] == 0,
          f"{label}: B2 latent launches {n['paged_attention_latent']} != {L} x ({steps} + "
          f"{out['prefill_chunks']}); per-head B2 {n['paged_attention']}, B1 "
          f"{n['flash_prefill']}")
    if not quantized:
        check(n["quant_matmul"] == n["quant_matmul_moe"] == 0, f"{label}: B3 ran on bf16 weights")
        return
    b3 = n["quant_matmul"] + n["matmul_dequant_calls"]
    check(n["quant_matmul"] > 0 and b3 == 6 * L * (steps + passes),
          f"{label}: B3 launches {n['quant_matmul']} + dequant calls "
          f"{n['matmul_dequant_calls']} != 6 x {L} x ({steps} + {passes})")
    moe = n["quant_matmul_moe"] + n["moe_dequant_calls"]
    check(n["quant_matmul_moe"] > 0 and moe == 3 * (L - cfg.first_k_dense) * (steps + passes),
          f"{label}: expert launches {n['quant_matmul_moe']} + dequant {n['moe_dequant_calls']}"
          f" != 3 x {L - cfg.first_k_dense} x ({steps} + {passes})")
    check(out["dequant_small_float_calls"] == 0,
          f"{label}: {out['dequant_small_float_calls']} dequant-route calls at <= 256 rows")
    check(n["quant_unembed"] == steps + out["admissions"] + out["chunked_admits"],
          f"{label}: B4 launches {n['quant_unembed']}")


def _deepseek_expert_bytes(cfg, params, gen) -> dict:
    """Bytes of the routed experts' weights one decode step reads: the
    every-expert route (`_expert_rows`, the served decode route) reads all
    E experts of every MoE layer; a route that gathered only the active
    experts would read those the batch's 8 tokens select, counted here
    from one eager decode step of 8 random tokens."""
    from localai_tpu_torch.models import llama

    route, sels = llama._moe_route, []

    def recording(cfg_, lp, x):
        w, sel = route(cfg_, lp, x)
        sels.append(sel)
        return w, sel

    cache = llama.KVCache.zeros(cfg, 8, 16, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (8,), generator=gen, device="cuda")
    with swapped(llama, "_moe_route", recording):
        llama.decode_step(cfg, params, toks, torch.zeros(8, dtype=torch.int64, device="cuda"),
                          cache)
    per_expert = sum(params["layers"][k][0, 0].numel() * params["layers"][k].element_size()
                     for k in ("w_gate", "w_up", "w_down"))
    active = [int(torch.unique(s).numel()) for s in sels]
    every = len(sels) * cfg.num_experts * per_expert
    return dict(every_expert_bytes=every, every_expert_floor_ms=every / PEAK_BYTES * 1e3,
                active_experts_per_layer=active,
                active_expert_bytes=sum(active) * per_expert,
                active_expert_floor_ms=sum(active) * per_expert / PEAK_BYTES * 1e3)


def phase_deepseek(latent_rows: list[dict]) -> dict:
    """deepseek-v2-lite at full width, DEEPSEEK_LAYERS of its 27 layers
    (one dense, the rest MoE of 64 routed experts, top 6, and 2 shared; MLA
    with a 512 + 64 latent) in bf16, seeded random weights drawn on the
    card: (1) one
    3000-token prompt's last logits, full-rank dense prefill against the
    absorbed paged chunks, within the near-tie bound; (2) phase 6's prompts
    (DEEPSEEK_NEW new tokens each, to hold the run's time) through the
    paged engine after warmup(), graphs against the eager body
    (ids and launches identical; B2's latent form once a layer a decode
    step), then a follow-up sharing request 5's first 1536 tokens, a prefix
    hit whose tail walks the shared latent pages; (3) the dense engine on
    the same traffic: ids equal to the paged engine's or parting at a near
    tie; (4) the decode step's device time from a graph replay, B2's
    share, the weight and latent bytes, and the every-expert route's
    bytes a step beside the active experts' floor."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama

    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"), num_layers=DEEPSEEK_LAYERS)
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for stack in ("layers", "dense_layers")
                 for t in params[stack].values()) + sum(
        params[k].numel() * params[k].element_size() for k in ("embed", "final_norm", "lm_head"))
    init = dict(init_s=time.monotonic() - t0, weight_bytes=wbytes,
                allocated_gib=torch.cuda.memory_allocated() / 2**30,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[deepseek-v2-lite bf16] random weights on the card: {json.dumps(init)}")
    gen = torch.Generator(device="cuda").manual_seed(19)

    # (1) dense prefill against the paged chunks, one 3000-token prompt.
    prompt = _serve_prompts(PAGED_PROMPTS)[5]
    n, C, page = len(prompt), PAGED_ENGINE["prefill_chunk"], PAGED_ENGINE["kv_page_size"]
    toks = torch.tensor([prompt], device="cuda")
    dense_logits = llama.prefill(cfg, params, toks, torch.tensor([n], device="cuda"))[0]
    MP = -(-n // page)
    pool = llama.paged_cache_zeros(cfg, MP + 1, page, device="cuda")
    table = torch.arange(MP, dtype=torch.int32, device="cuda")[None]
    for off in range(0, n, C):
        part = toks[:, off:off + C]
        pad = C - part.shape[1]
        chunk = torch.nn.functional.pad(part, (0, pad))
        paged_logits, pool = llama.prefill_chunk_paged(
            cfg, params, chunk, torch.tensor([part.shape[1]], device="cuda"),
            torch.tensor([off], device="cuda"), pool, table, with_logits=off + C >= n)
    del pool
    # The same dense prefill with the prompt in a batch of two (other matmul
    # shapes, the same function): the spread bf16 rounding alone gives.
    other = torch.randint(0, 256, (1, n), generator=gen, device="cuda")
    batch_logits = llama.prefill(cfg, params, torch.cat([toks, other]),
                                 torch.tensor([n, n], device="cuda"))[0][:1]
    scale = float(dense_logits.abs().max())
    a, b = int(dense_logits.argmax()), int(paged_logits.argmax())
    pre = dict(tokens=n, chunks=-(-n // C),
               max_rel_diff=float((paged_logits - dense_logits).abs().max()) / scale,
               batch_max_rel_diff=float((batch_logits - dense_logits).abs().max()) / scale,
               argmax_equal=a == b,
               # The dense logits' gap between the two choices (0 when equal).
               choice_gap=float(dense_logits[0, a] - dense_logits[0, b]),
               bound=PREFIX_LOGIT_TOL * scale)
    log(f"[deepseek-v2-lite prefill dense vs paged] {json.dumps(pre)}")
    check(bool(torch.isfinite(dense_logits).all()) and dense_logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(paged_logits).all()),
          "deepseek prefill logits not finite / wrong shape")
    # bf16 paths (full-rank against absorbed, every layer) give different
    # logits: they must sit within DEEPSEEK_PAGED_SPREAD times the spread
    # a batch of two gives, and the choice must agree up to a near tie.
    check(pre["max_rel_diff"] <= DEEPSEEK_PAGED_SPREAD * pre["batch_max_rel_diff"],
          f"deepseek: the paged chunks' logits sit farther from the dense prefill's than "
          f"{DEEPSEEK_PAGED_SPREAD} x a batch of two's spread: {pre}")
    check(pre["choice_gap"] <= pre["bound"],
          f"deepseek: the paged chunks' choice parts from the dense prefill's away from a "
          f"near tie: {pre}")
    experts = _deepseek_expert_bytes(cfg, params, gen)
    del dense_logits, paged_logits, batch_logits

    # (2) the paged engine: graphs against the eager body, and a prefix hit.
    follow = _deepseek_follow()

    def probe(eng):
        eng._stage_block(np.zeros_like(eng.h_active))
        graph = eng._graph_cache[eng._block_key(16, "greedy", 0)][0]
        return dict(device_ms_per_step=cuda_time_ms(graph.replay, reps=3, warmup=1) / 16)

    runs = phase_graphs("deepseek-v2-lite bf16 paged", cfg, params, probe=probe, keep_ids=True,
                        follow=follow, max_new=DEEPSEEK_NEW)
    for mode in ("graph", "eager"):
        _check_deepseek_launches(f"deepseek {mode}", cfg, runs[mode], quantized=False)
        _check_deepseek_launches(f"deepseek {mode} follow-up", cfg, runs[mode]["follow"],
                                 quantized=False)
    _check_graphs("deepseek graph", runs["graph"])
    hit = runs["graph"]["follow"]
    check(hit["prefix_hits"] == 1 and hit["prefill_chunks"] >= 1,
          f"deepseek: the follow-up request did not hit the shared prefix: {hit['prefix_hits']} "
          f"hits, {hit['prefill_chunks']} chunks")

    # (3) the dense engine on the same traffic.
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(max_slots=8, max_seq=4096, block_sizes=(16, 4, 1)))
    dense = _serve(eng, PAGED_PROMPTS, max_new=DEEPSEEK_NEW, keep_ids=True, stop=False)
    dense["follow"] = _serve(eng, [], max_new=DEEPSEEK_NEW, keep_ids=True, prompts=follow)
    del eng
    torch.cuda.empty_cache()
    check(dense["launches"]["paged_attention_latent"] == 0,
          "deepseek dense engine: B2 ran on a dense cache")
    prompts = _serve_prompts(PAGED_PROMPTS) + follow
    paged_ids = runs["graph"]["ids"] + runs["graph"]["follow"]["ids"]
    dense_ids = dense["ids"] + dense["follow"]["ids"]
    parts = []
    for i, (a, b) in enumerate(zip(dense_ids, paged_ids)):
        if a == b:
            continue
        kw = (dict(temperature=0.8, top_p=0.9, seed=100 + i) if i % 2 == 1 and i < 10
              else dict(temperature=0.0, seed=100 + i) if i < 10 else dict(seed=100))
        parts.append(dict(request=i, **_part_gap(cfg, params, prompts[i], a, b, kw)))
    log(f"[deepseek-v2-lite paged vs dense ids] {json.dumps(dict(requests=len(paged_ids), parts=parts))}")
    for part in parts:
        check(part["gap"] <= part["bound"],
              f"deepseek: the paged engine's ids part from the dense engine's away from a "
              f"near tie: {part}")

    g = runs["graph"]
    latent_decode = next(r for r in latent_rows if r["shape"] == "decode"
                         and r["pool_dtype"] == "bfloat16")
    step_ms = g["probe"]["device_ms_per_step"]
    summary = dict(
        init=init, prefill=pre, **experts,
        weight_bytes=g["weight_bytes"], kv_bytes_per_token=L * cfg.cache_k_dim * 2,
        per_head_kv_bytes_per_token=L * cfg.num_heads * (cfg.qk_head_dim + cfg.v_head_dim) * 2,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        ttft_ms_p50=g["ttft_ms_p50"], ttft_ms_max=g["ttft_ms_max"],
        decode_tok_s=g["decode_tok_s"], decode_ms_per_step=g["decode_ms_per_step"],
        device_ms_per_step_idle_replay=step_ms,
        # A microbench product, not a reading of the served step: L x the
        # decode row of phase latent_kernels (limits 1-4096) over an idle
        # slots' replay. B2's traced share of a served step comes from
        # profile_engine.py --arch deepseek-v2-lite --paged.
        b2_latent_microbench_ms_x_layers=L * latent_decode["ms"],
        b2_latent_microbench_over_idle_replay=L * latent_decode["ms"] / step_ms,
        b2_latent_launches_per_decode_step=L,
        prefix_hit=dict(ttft_ms=hit["ttft_ms_p50"], prefix_hits=hit["prefix_hits"],
                        chunks=hit["prefill_chunks"]),
        dense_engine=dict(decode_tok_s=dense["decode_tok_s"], ttft_ms_p50=dense["ttft_ms_p50"]),
        ids_parting=len(parts), graphs=runs["summary"])
    log(f"[deepseek-v2-lite bf16 paged] {json.dumps(summary)}")
    e = runs["eager"]
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"summary": summary, "graph": g, "eager": e, "dense": dense}


def phase_deepseek_int4() -> dict:
    """deepseek-v2-lite int4 at full width, 8 of its 27 layers (cut for
    time), drawn straight into the quantized form, through the paged
    engine with phase 6's requests: B3 (the q, latent and output
    projections, the dense MLP and the shared experts), B3's expert form at
    E = 64, B4 (the int8 head) and B2's latent form, each by its launch
    identity."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, quant

    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"), num_layers=DEEPSEEK_INT4_LAYERS)
    params = quant.init_params_quantized(cfg, seed=2, mode="int4", device="cuda")
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(**PAGED_ENGINE))
    out = _serve(eng, PAGED_PROMPTS)
    del eng, params
    torch.cuda.empty_cache()
    log(f"[deepseek-v2-lite int4, {cfg.num_layers} layers] " + json.dumps(out))
    _check_deepseek_launches("deepseek int4", cfg, out, quantized=True)
    _check_graphs("deepseek int4", out)
    return out


def phase_deepseek_small() -> dict:
    """tiny-mla (DeepSeek-V3-shaped: q-lora, sigmoid router with a selection
    bias, group-limited top-k, a shared expert, a dense first layer; a
    latent of 32 + 16) in f32 on the card against the CPU: the dense
    engine, the paged + chunked engine (B2's f32 latent form at D = 48) and
    prompt_lookup on the paged pool. Greedy ids must be equal."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama

    cfg = dataclasses.replace(get_arch("tiny-mla"), dtype="float32")
    p_cpu = llama.init_params(cfg, seed=0, scale=0.06, device="cpu")
    p_cpu["layers"]["router_bias"] = torch.randn(
        p_cpu["layers"]["router_bias"].shape, generator=torch.Generator().manual_seed(5)) * 0.05
    p_gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    base = dict(max_slots=4, max_seq=256, min_prefill_bucket=16, block_sizes=(8,))
    paged = dict(kv_pages=40, kv_page_size=16, prefill_chunk=32)
    layouts = {"dense": {}, "paged": paged, "prompt_lookup": dict(paged, spec_mode="prompt_lookup")}
    prompts = [([65, 66, 67], {}), (list(range(40, 140)), {}), ([5, 6] * 30, {}),
               ([10] + [77] * 20, {77: 25.0})]
    out = {}
    for name, kw in layouts.items():
        ids = {}
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            eng = Engine(cfg, p, ByteTokenizer(cfg.vocab_size), device=dev,
                         engine_cfg=EngineConfig(**base, **kw))
            eng.start()
            if dev == "cuda":
                _zero_counts()
            ids[dev] = [[e.token_id for e in eng.submit(GenRequest(
                prompt_ids=pr, max_new_tokens=24, ignore_eos=True, logit_bias=b))
                if e.kind == "token"] for pr, b in prompts]
            if dev == "cuda":
                launches = _read_counts()
            m = eng.metrics()
            eng.stop()
        out[name] = dict(ids_equal=ids["cpu"] == ids["cuda"],
                         latent_launches=launches["paged_attention_latent"],
                         spec_rounds=m.get("spec_rounds", 0.0))
        check(ids["cpu"] == ids["cuda"], f"tiny-mla {name}: card ids differ from CPU ids")
        check((launches["paged_attention_latent"] > 0) == (name != "dense"),
              f"tiny-mla {name}: {launches['paged_attention_latent']} latent B2 launches")
        if name == "prompt_lookup":
            check(m["spec_rounds"] > 0, "tiny-mla prompt_lookup: no speculative round ran")
    log(f"[deepseek tiny-mla card vs cpu] {json.dumps(out)}")
    return out


def phase_deepseek_http() -> dict:
    """The port's server with a YAML naming deepseek-v2-lite at
    DEEPSEEK_LAYERS of its 27 layers (registered as the preset
    DEEPSEEK_PRESET; 27 until phase 26 joined: the run's time; bf16, seeded
    random weights, the paged pool): 4 concurrent chats of 100-400
    characters, half streamed, each 16 tokens (short: the run's time); every
    response 200, every stream ending in [DONE]."""
    import random

    import yaml

    from localai_tpu_torch.models.config import PRESETS, get_arch

    PRESETS.setdefault(DEEPSEEK_PRESET, dataclasses.replace(get_arch("deepseek-v2-lite"),
                                                            num_layers=DEEPSEEK_LAYERS))

    rnd = random.Random(19)
    reqs = []
    for i in range(4):
        text = "".join(rnd.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(100 * (i + 1)))
        reqs.append(("/v1/chat/completions", "deepseek",
                     {"model": "deepseek", "messages": [{"role": "user", "content": text}],
                      "max_tokens": 16, "ignore_eos": True, "stream": i % 2 == 1,
                      "temperature": 0.0 if i < 2 else 0.8, "seed": 7 + i}))
    with tempfile.TemporaryDirectory() as root:
        with open(f"{root}/deepseek.yaml", "w") as f:
            yaml.safe_dump({"name": "deepseek", "model": DEEPSEEK_PRESET,
                            "context_size": 4096, "max_slots": 8, "kv_pages": 256,
                            "kv_page_size": 128, "prefill_chunk": 512, "max_tokens": 16,
                            "tokenizer": "synthetic-bytes"}, f)
        manager, server, base = _start_server(root)
        try:
            results, wall = _http_batch(base, reqs)
            _texts, ttfts = _check_http_results("deepseek_http", reqs, results, n_tokens=16)
        finally:
            server.shutdown()
            manager.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(requests=len(reqs), statuses=[r["status"] for r in results], wall_s=wall,
               stream_ttft_ms=[t * 1e3 for t in ttfts])
    log(f"[deepseek_http] {json.dumps(out)}")
    return out


def _route_margins(cfg, lp, x) -> dict:
    """The deepseek router's view of the last row of x: the selected
    experts (ascending), and the margin between the k-th and (k+1)-th
    selection scores (softmax, plus the bias where there is one)."""
    from localai_tpu_torch.models import llama

    row = x.reshape(-1, x.shape[-1])[-1:]
    scores = torch.softmax(row.float() @ lp["router"].float(), dim=-1)[0]
    if "router_bias" in lp:
        scores = scores + lp["router_bias"].float()
    k = cfg.num_experts_per_token
    top = torch.sort(scores, descending=True, stable=True)
    sel = sorted(int(i) for i in llama._top_idx(scores[None], k)[0])
    return dict(sel=sel, margin=float(top.values[k - 1] - top.values[k]),
                kth=float(top.values[k - 1]))


def diagnose_deepseek_parting(layers: int = 8) -> dict:
    """Why the dense and paged deepseek engines' ids part at `layers`
    layers (ROADMAP Queue C). (1) phase deepseek's traffic through a paged
    engine (graphs, after warmup) and a dense engine at `layers` layers,
    each parting held by `_part_gap` as the phase holds it; (2) for each
    parting request, the step that produced the parting token computed on
    one row four ways: the dense engine's path (full-rank prefill of the
    common ids but the last, then one absorbed decode step on the dense
    cache), the paged engine's (512-token chunks into pages through B2's
    latent form, then one paged decode step), a plain bf16 prefill of the
    common ids, and the same prefill on f32 weights; per path the last
    row's expert choice in every MoE layer with its k-th / (k+1)-th score
    margin, and the logits' distance from the f32 witness; (3) the paged
    step again, with the dense step's expert choice forced at the first
    layer where the two choose apart: if that alone brings the logits to
    the dense step's, the parting is a routing near tie."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama

    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"), num_layers=layers)
    params = llama.init_params(cfg, seed=0, device="cuda")
    follow = _deepseek_follow()
    prompts = _serve_prompts(PAGED_PROMPTS) + follow

    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(**PAGED_ENGINE))
    eng.warmup()
    paged = _serve(eng, PAGED_PROMPTS, max_new=DEEPSEEK_NEW, keep_ids=True, stop=False)
    paged_follow = _serve(eng, [], max_new=DEEPSEEK_NEW, keep_ids=True, prompts=follow)
    del eng
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(max_slots=8, max_seq=4096, block_sizes=(16, 4, 1)))
    dense = _serve(eng, PAGED_PROMPTS, max_new=DEEPSEEK_NEW, keep_ids=True, stop=False)
    dense_follow = _serve(eng, [], max_new=DEEPSEEK_NEW, keep_ids=True, prompts=follow)
    del eng
    torch.cuda.empty_cache()
    paged_ids = paged["ids"] + paged_follow["ids"]
    dense_ids = dense["ids"] + dense_follow["ids"]

    route = llama._deepseek_route
    n_dense = cfg.first_k_dense

    def recorded(step, force=None):
        """step() with every MoE layer's route of the last row recorded;
        `force` = (MoE layer, experts) replaces that layer's selection."""
        recs = []

        def rec(cfg_, lp, x):
            recs.append(_route_margins(cfg_, lp, x))
            w, sel = route(cfg_, lp, x)
            if force is not None and len(recs) - 1 == force[0]:
                scores = torch.softmax(x.float() @ lp["router"].float(), dim=-1)
                sel = torch.tensor(force[1], device=sel.device).expand_as(sel).contiguous()
                w = torch.gather(scores, -1, sel)
                if cfg_.norm_topk_prob and sel.shape[-1] > 1:
                    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
                else:
                    w = w * cfg_.routed_scaling_factor
            return w, sel

        with swapped(llama, "_deepseek_route", rec):
            out = step()
        return out[0][0].float(), recs

    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    C, page = PAGED_ENGINE["prefill_chunk"], PAGED_ENGINE["kv_page_size"]
    L = cfg.num_layers
    parts = []
    for i, (want, got) in enumerate(zip(dense_ids, paged_ids)):
        if want == got:
            continue
        kw = (dict(temperature=0.8, top_p=0.9, seed=100 + i) if i % 2 == 1 and i < 10
              else dict(temperature=0.0, seed=100 + i) if i < 10 else dict(seed=100))
        gap = _part_gap(cfg, params, prompts[i], want, got, kw)
        p = gap["position"]
        seq = list(prompts[i]) + list(want[:p])  # the step's input: seq[-1] at len - 1
        n = len(seq) - 1
        toks = torch.tensor([seq], device="cuda")
        tok, pos = toks[:, -1], torch.tensor([n], device="cuda")

        def window():
            return dict(local_k=torch.zeros((L, 1, 1, 1, cfg.cache_k_dim), dtype=torch.bfloat16,
                                            device="cuda"),
                        local_v=torch.zeros((L, 1, 1, 1, cfg.cache_v_dim), dtype=torch.bfloat16,
                                            device="cuda"))

        # The dense engine's path: full-rank prefill, then an absorbed step.
        _lg, ks, vs = llama.prefill(cfg, params, toks[:, :n], torch.tensor([n], device="cuda"))
        cache = llama.KVCache.zeros(cfg, 1, n + 16, device="cuda")
        llama.write_prefill_to_cache(cache, ks, vs, 0)
        del ks, vs
        # The paged engine's path: chunks into pages (B2's latent form), then
        # a paged step.
        MP = -(-(n + 1) // page)
        pool = llama.paged_cache_zeros(cfg, MP + 1, page, device="cuda")
        table = torch.arange(MP, dtype=torch.int32, device="cuda")[None]
        for off in range(0, n, C):
            part = toks[:, off:min(off + C, n)]
            chunk = torch.nn.functional.pad(part, (0, C - part.shape[1]))
            _lg, pool = llama.prefill_chunk_paged(
                cfg, params, chunk, torch.tensor([part.shape[1]], device="cuda"),
                torch.tensor([off], device="cuda"), pool, table, with_logits=False)

        def dense_step():
            return llama.decode_step_windowed(cfg, params, tok, pos, cache, step=0, **window())

        def paged_step():
            return llama.decode_step_windowed(cfg, params, tok, pos, pool, step=0,
                                              ptable=table, **window())

        def plain(c, prm):
            return lambda: llama.prefill(c, prm, toks, torch.tensor([n + 1], device="cuda"))

        runs = {}
        for name, fn in (("dense_step", dense_step), ("paged_step", paged_step),
                         ("plain_bf16", plain(cfg, params)), ("plain_f32", plain(cfg32, p32))):
            logits, recs = recorded(fn)
            runs[name] = dict(logits=logits, routes=recs)
        f32 = runs["plain_f32"]["logits"]
        f32_routes = runs["plain_f32"]["routes"]
        summary = {name: dict(max_abs_from_f32=float((r["logits"] - f32).abs().max()),
                              choice=int(r["logits"].argmax()),
                              moe_layers_choosing_as_f32=sum(
                                  a["sel"] == b["sel"] for a, b in zip(r["routes"], f32_routes)))
                   for name, r in runs.items()}
        d_routes, p_routes = runs["dense_step"]["routes"], runs["paged_step"]["routes"]
        flips = [dict(moe_layer=j, layer=j + n_dense, dense_sel=a["sel"], paged_sel=b["sel"],
                      dense_margin=a["margin"], paged_margin=b["margin"], kth=a["kth"],
                      f32_sel=f32_routes[j]["sel"], f32_margin=f32_routes[j]["margin"])
                 for j, (a, b) in enumerate(zip(d_routes, p_routes)) if a["sel"] != b["sel"]]
        forced = None
        if flips:
            j = flips[0]["moe_layer"]
            lf, _r = recorded(paged_step, force=(j, flips[0]["dense_sel"]))
            dl = runs["dense_step"]["logits"]
            forced = dict(moe_layer=j, max_abs_from_dense_step=float((lf - dl).abs().max()),
                          unforced_max_abs_from_dense_step=float(
                              (runs["paged_step"]["logits"] - dl).abs().max()),
                          choice=int(lf.argmax()))
        del cache, pool
        parts.append(dict(request=i, prompt_tokens=len(prompts[i]), part=gap,
                          logit_scale_f32=float(f32.abs().max()), paths=summary, flips=flips,
                          forced=forced,
                          min_margin_dense=min(r["margin"] for r in d_routes),
                          min_margin_paged=min(r["margin"] for r in p_routes)))
        log(f"[deepseek parting {layers} layers, request {i}] {json.dumps(parts[-1])}")
    out = dict(layers=layers, requests=len(paged_ids), parting=[p["request"] for p in parts],
               parts=parts)
    log(f"[deepseek parting {layers} layers] {json.dumps(out)}")
    del params, p32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def diagnose_deepseek_engine_step(layers: int = 8, request: int = 9) -> dict:
    """The served step behind a parting (ROADMAP Queue C): phase deepseek's
    traffic through the paged and the dense engine at `layers` layers, each
    with its decode blocks run eagerly (the graph's body, whose ids the
    phase holds equal to the graphs'), recording the logits row, token,
    seed and sampling fields of `request`'s slot at its first decode step.
    Each row is held against a plain prefill of the same ids on f32 weights,
    and re-sampled with the request's seed and position: whether the
    engine's pick follows from its own logits, how far those logits sit
    from the witness, and where the sampler's candidate (top 64) and top-p
    cuts fall for each path's logits, with both picks' ranks and noise."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama
    from localai_tpu_torch.ops.sampling import SamplingParams, _filter_sorted, gumbel_noise, sample

    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"), num_layers=layers)
    params = llama.init_params(cfg, seed=0, device="cuda")
    prompts = _serve_prompts(PAGED_PROMPTS)
    n = len(prompts[request])
    kw = (dict(temperature=0.8, top_p=0.9, seed=100 + request) if request % 2 == 1
          else dict(temperature=0.0, seed=100 + request))
    orig = llama.decode_step_windowed
    runs = {}
    for label, ecfg in (("paged", EngineConfig(**PAGED_ENGINE)),
                        ("dense", EngineConfig(max_slots=8, max_seq=4096,
                                               block_sizes=(16, 4, 1)))):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda", engine_cfg=ecfg)
        seen = []

        def rec(cfg_, params_, tokens, positions, *a, **k):
            out = orig(cfg_, params_, tokens, positions, *a, **k)
            hit = (positions == n).nonzero()
            if hit.numel():
                r = int(hit[0, 0])
                seen.append(dict(row=r, logits=out[0][r].float().clone(), token=int(tokens[r]),
                                 seed=int(eng.d_seed[r]),
                                 fields=[float(v) for v in eng._b_pack[1:8, r]],
                                 counts=int(eng.counts[r].sum()),
                                 bias_nonzero=int((eng.bias[r] != 0).sum())))
            return out

        with swapped(eng, "_decode_block", eng._block_body), \
                swapped(llama, "decode_step_windowed", rec):
            eng.warmup()
            out = _serve(eng, PAGED_PROMPTS, max_new=DEEPSEEK_NEW, keep_ids=True)
        del eng
        torch.cuda.empty_cache()
        check(len(seen) == 1, f"{label}: {len(seen)} decode steps at position {n}")
        runs[label] = dict(ids=out["ids"][request], **seen[0])
    ids = runs["dense"]["ids"]
    seq = prompts[request] + ids[:1]
    toks = torch.tensor([seq], device="cuda")
    lens = torch.tensor([len(seq)], device="cuda")
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    f32 = llama.prefill(dataclasses.replace(cfg, dtype="float32"), p32, toks, lens)[0][0].float()
    del p32
    bf16 = llama.prefill(cfg, params, toks, lens)[0][0].float()
    sp = SamplingParams.make(1, temperature=kw["temperature"], top_p=kw.get("top_p", 1.0),
                             device="cuda")
    seed, pos = torch.tensor([kw["seed"]], device="cuda"), torch.tensor([n + 1], device="cuda")

    def pick(logits):
        return int(sample(logits[None], seed, pos, sp)[0])

    picks = sorted({runs["paged"]["ids"][1], runs["dense"]["ids"][1]})

    def nucleus(logits):
        """Where the sampler's cuts fall: its 64 candidates (top-k by
        logit), the top-p set among them, each pick's rank, whether it is
        kept, and the logit margins at both cuts."""
        sl, si = torch.topk(logits, 65)
        kept = _filter_sorted(sl[None, :64], sp)[0] > -1e29
        nk = int(kept.sum())
        rank = {int(t): r for r, t in enumerate(si.tolist())}
        g = gumbel_noise(seed, pos, logits.shape[-1])[0]
        return dict(kept=nk, candidate_cut_margin=float(sl[63] - sl[64]),
                    top_p_cut_margin=float(sl[nk - 1] - sl[nk]) if nk < 64 else None,
                    spread_of_candidates=float(sl[0] - sl[63]),
                    picks={str(t): dict(rank=rank.get(t), kept=bool(rank.get(t, 99) < nk),
                                        noise=float(g[t]), logit=float(logits[t]))
                           for t in picks})

    out = dict(layers=layers, request=request, prompt_tokens=n, sampling=kw,
               f32_pick=pick(f32), plain_bf16_pick=pick(bf16),
               plain_bf16_max_abs_from_f32=float((bf16 - f32).abs().max()),
               f32_scale=float(f32.abs().max()), f32_nucleus=nucleus(f32),
               plain_bf16_nucleus=nucleus(bf16))
    for label, r in runs.items():
        lg = r.pop("logits")
        out[label] = dict(r, served_second_id=r["ids"][1], ids=r["ids"][:4],
                          repick_with_request_seed=pick(lg),
                          max_abs_from_f32=float((lg - f32).abs().max()),
                          top2_gap=float(torch.topk(lg, 2).values.diff().abs()[0]),
                          nucleus=nucleus(lg))
    log(f"[deepseek engine step {layers} layers, request {request}] {json.dumps(out)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 23. observe: the journal, traces, timeline, profile windows, faults,
#     crash-only restart and quarantine on llama-3.2-1b (4 of 16 layers, bf16)
# --------------------------------------------------------------------------- #

OBSERVE_YAML = dict(LORA_BASE_YAML, name="obs-1b", trace_journal_events=4096)
# Chat contents of the traced requests (the synthetic byte tokenizer: one
# token a character): two chunked admissions, the rest single-shot.
OBSERVE_CHATS = [60, 200, 400, 900, 60, 200, 400, 1400]
OBSERVE_NEW = 16  # one 16-step block a chat (32 until phase 25 joined: the run's time)
# Journal cost: rounds of 8 requests of 20 tokens, 96 new tokens each (the
# JAX package's 96-token round), journal on and off interleaved.
OBSERVE_COST_ROUNDS = 5
OBSERVE_COST_NEW = 96
# The fault sweep: three seeds of 16 requests on a swapping pool, the
# sites of the main path's dispatch, commit, allocator and swap tier.
OBSERVE_FAULT_SEEDS = (1, 2, 3)
OBSERVE_FAULT_SITES = ("device_dispatch", "control_commit", "page_alloc", "host_swap")
OBSERVE_FAULT_RATES = {"device_dispatch": 0.03, "control_commit": 0.05, "page_alloc": 0.1,
                       "host_swap": 0.5}
# Two chunks a prompt, 5 pages an admission (no headroom): 8 slots fill the
# 40-page pool, and every request outgrows its pages within its 96 new
# tokens, so growth preempts (and swaps) the youngest slot.
OBSERVE_FAULT_ENGINE = dict(PAGED_ENGINE, kv_pages=40, kv_page_headroom=0,
                            prefix_cache_entries=0)
OBSERVE_FAULT_PROMPTS = [560, 570, 580, 590, 600, 610, 620, 640] * 2
OBSERVE_FAULT_NEW = 96
OBSERVE_DEADLINE_S = 180.0  # every request of a fault run ends within this
# Supervision: two restarts, then the third death in the window quarantines.
OBSERVE_APP = dict(restart_budget=2, restart_window_s=600.0, quarantine_s=2.0)


def _http_call(base: str, method: str, path: str, payload=None, headers=None,
               timeout: float = 300.0) -> tuple[int, dict, object]:
    """(status, headers, parsed JSON or text) of one HTTP call."""
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, dict(e.headers)
    try:
        return status, hdrs, json.loads(raw)
    except ValueError:
        return status, hdrs, raw.decode()


def _obs_text(n: int, seed: int) -> str:
    import random

    rnd = random.Random(seed)
    return "".join(rnd.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(n))


def _obs_traces(base: str, eng) -> dict:
    """8 concurrent chats, 4 with a client traceparent: each response's
    /debug/trace span tree, trace id and TTFT; B1 / B2 by their launch
    identities over the run."""
    from localai_tpu_torch.observe.trace import new_traceparent, parse_traceparent

    results: list = [None] * len(OBSERVE_CHATS)
    tps = [new_traceparent() if i % 2 == 0 else "" for i in range(len(OBSERVE_CHATS))]

    def one(i: int, n: int) -> None:
        body = {"model": "obs-1b", "max_tokens": OBSERVE_NEW, "ignore_eos": True,
                "messages": [{"role": "user", "content": _obs_text(n, i)}],
                "temperature": 0.0 if i % 2 == 0 else 0.8, "top_p": 1.0 if i % 2 == 0 else 0.9,
                "seed": 300 + i}
        headers = {"Extra-Usage": "1", **({"traceparent": tps[i]} if tps[i] else {})}
        t0 = time.monotonic()
        results[i] = _http_call(base, "POST", "/v1/chat/completions", body, headers) + (
            time.monotonic() - t0,)

    _zero_counts()
    m0 = eng.metrics()
    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i, n)) for i, n in enumerate(OBSERVE_CHATS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    chats_s = time.monotonic() - t0
    launches = _read_counts()
    m1 = eng.metrics()
    check(all(not th.is_alive() for th in threads), "observe traces: a chat never finished")
    delta = {k: int(m1[k] - m0[k]) for k in ("admissions", "decode_steps", "prefill_chunks",
                                            "decode_blocks", "decode_graph_captures",
                                            "decode_graph_replays", "chunked_admits")}
    L = eng.cfg.num_layers
    check(launches["paged_attention"] == L * (delta["decode_steps"] + delta["prefill_chunks"])
          and launches["paged_attention"] > 0,
          f"observe traces: B2 launches {launches['paged_attention']} != {L} x "
          f"({delta['decode_steps']} steps + {delta['prefill_chunks']} chunks)")
    check(launches["flash_prefill"] == L * delta["admissions"] and launches["flash_prefill"] > 0,
          f"observe traces: B1 launches {launches['flash_prefill']} != {L} x "
          f"{delta['admissions']} admissions")
    _check_graphs("observe traces", delta)
    rows = []
    for i, (status, _h, body, wall) in enumerate(results):
        check(status == 200, f"observe traces: chat {i} got HTTP {status}: {body}")
        rid = body["id"]
        st, _h2, tr = _http_call(base, "GET", f"/debug/trace/{rid}")
        check(st == 200, f"observe traces: /debug/trace/{rid} answered {st}")
        leg = tr["legs"][-1]
        spans = {s["name"]: s["duration_ms"] for s in leg["spans"]}
        tiled = sum(s["duration_ms"] for s in leg["spans"])
        row = dict(request_id=rid, trace_id=tr["trace_ids"][0], client=bool(tps[i]),
                   complete=leg["complete"], terminal_events=leg["terminal_events"],
                   spans=[s["name"] for s in leg["spans"]], wall_ms=leg["wall_ms"],
                   tiled_ms=tiled, ttft_ms=spans.get("queue", 0.0) + spans.get("admit", 0.0),
                   admit_ms=spans.get("admit", 0.0),
                   timing_prompt_processing_ms=body["usage"]["timing_prompt_processing"] * 1e3,
                   client_wall_ms=wall * 1e3)
        rows.append(row)
        if tps[i]:
            check(row["trace_id"] == parse_traceparent(tps[i])[0],
                  f"observe traces: {rid}'s trace id is not the client's: {row}")
        check(row["complete"] and row["terminal_events"] == 1
              and row["spans"][:3] == ["queue", "admit", "decode"],
              f"observe traces: {rid}'s span tree: {row}")
        # The spans tile submit -> terminal (each duration rounded to 1 µs).
        check(abs(tiled - row["wall_ms"]) <= 0.002 * len(leg["spans"]) + 1e-6,
              f"observe traces: {rid}'s spans do not tile its wall: {row}")
        check(abs(row["admit_ms"] - row["timing_prompt_processing_ms"]) <= 5.0,
              f"observe traces: {rid}'s admission -> first token {row['admit_ms']:.3f} ms "
              f"against the response's timing_prompt_processing "
              f"{row['timing_prompt_processing_ms']:.3f} ms")
        check(row["ttft_ms"] <= row["client_wall_ms"],
              f"observe traces: {rid}'s TTFT past the client's wall: {row}")
    out = dict(requests=len(rows), client_traceparents=sum(bool(t) for t in tps), **delta,
               chats_s=chats_s, trace_reads_s=time.monotonic() - t0 - chats_s,
               client_wall_ms=[round(r["client_wall_ms"], 1) for r in rows],
               launches={k: v for k, v in launches.items() if v},
               ttft_ms_p50=statistics.median(r["ttft_ms"] for r in rows),
               max_admit_vs_timing_ms=max(abs(r["admit_ms"] - r["timing_prompt_processing_ms"])
                                          for r in rows),
               max_tile_gap_ms=max(abs(r["tiled_ms"] - r["wall_ms"]) for r in rows))
    log("[observe traces] " + json.dumps(out))
    out["run"] = dict(launches=launches, **delta)
    return out


def _obs_timeline(base: str) -> dict:
    """/debug/timeline as Chrome trace JSON: every decode block's window
    carries a fenced device ms in (0, the window's wall], and every window's
    phase vector sums to at most its wall (the time since the last window)."""
    st, _h, tl = _http_call(base, "GET", "/debug/timeline")
    check(st == 200 and isinstance(tl, dict) and isinstance(tl.get("traceEvents"), list),
          f"observe timeline: /debug/timeline answered {st}")
    evs = [e for e in tl["traceEvents"] if e.get("ph") in ("X", "i")]
    for e in evs:
        check({"name", "pid", "tid", "ts", "args"} <= set(e) and e["ts"] >= 0,
              f"observe timeline: not a Chrome trace event: {e}")
        e["t_us"] = e["ts"] + e.get("dur", 0.0)  # the journal's stamp
    evs.sort(key=lambda e: (e["args"]["seq"] < 0, e["args"]["seq"]))
    windows = [e for e in evs if e["name"] == "loop_iter"]
    blocks = [e for e in evs if e["name"] == "decode_block"]
    check(windows and blocks, "observe timeline: no loop_iter or decode_block events")
    fenced, over = [], []
    for prev, w in zip(windows, windows[1:]):
        wall_ms = (w["t_us"] - prev["t_us"]) / 1e3
        total = sum(w["args"].get("phases", {}).values())
        if total > wall_ms + 0.01:
            over.append((w["args"]["seq"], total, wall_ms))
    check(not over, f"observe timeline: windows whose phases exceed their wall: {over[:5]}")
    by_seq = [(w["args"]["seq"], w) for w in windows]
    for b in blocks:
        w = next((w for s, w in by_seq if s > b["args"]["seq"]), None)
        if w is None:
            continue
        wall_ms = sum(w["args"].get("phases", {}).values())
        fenced.append((w["args"]["b"], wall_ms))
        check(0.0 < w["args"]["b"] <= wall_ms + 0.01,
              f"observe timeline: decode block {b['args']['seq']}'s fenced device ms "
              f"{w['args']['b']} outside (0, its window's {wall_ms:.3f} ms]")
    out = dict(events=len(tl["traceEvents"]), windows=len(windows), blocks=len(blocks),
               fenced_blocks=len(fenced),
               fenced_ms_p50=statistics.median(f for f, _w in fenced),
               fenced_over_window_p50=statistics.median(f / w for f, w in fenced),
               bytes=len(json.dumps(tl)))
    log("[observe timeline] " + json.dumps(out))
    return out


def _obs_profile(base: str, eng, prof_dir: str) -> dict:
    """/debug/profile {"seconds": 2} while streaming chats run: a concurrent
    window gets 409; the exported trace holds B2's launches from graph
    replays and B1's from admissions inside the window; the first chats'
    logprob blocks capture their graph inside it."""
    res: dict = {}

    def profile() -> None:
        res["profile"] = _http_call(base, "POST", "/debug/profile", {"seconds": 2})

    chats: list = [None] * 8

    def chat(i: int) -> None:
        # The first batch asks for logprobs: its blocks' graph (the logprob
        # epilogue's key) is captured inside the window.
        body = {"model": "obs-1b", "max_tokens": OBSERVE_NEW, "ignore_eos": True,
                "stream": True, "temperature": 0.7, "seed": 500 + i,
                "messages": [{"role": "user", "content": _obs_text(300, 50 + i)}],
                **({"logprobs": True, "top_logprobs": 2} if i < 4 else {})}
        chats[i] = _http(base, "/v1/chat/completions", body, time.monotonic())

    m0 = eng.metrics()
    threads = [threading.Thread(target=profile)]
    threads[0].start()
    time.sleep(0.3)
    res["concurrent"] = _http_call(base, "POST", "/debug/profile", {"seconds": 0.5})
    for batch in ((0, 1, 2, 3), (4, 5, 6, 7)):  # the second batch replays
        ts = [threading.Thread(target=chat, args=(i,)) for i in batch]
        for th in ts:
            th.start()
        threads += ts
        time.sleep(0.6)
    for th in threads:
        th.join(timeout=300)
    m1 = eng.metrics()
    t_parse = time.monotonic()
    check(res["concurrent"][0] == 409,
          f"observe profile: a concurrent window answered {res['concurrent'][0]}, not 409")
    st, _h, body = res["profile"]
    check(st == 200 and os.path.isfile(body.get("file", "")),
          f"observe profile: /debug/profile answered {st}: {body}")
    ok = [c is not None and c["status"] == 200 and c["frames"][-1] == "[DONE]"
          and not any('"error"' in f for f in c["frames"]) for c in chats]
    with open(body["file"]) as f:
        trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", []) if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in kernels]
    cpu_ops = [e for e in trace.get("traceEvents", []) if e.get("cat") == "cpu_op"]
    out = dict(file_bytes=os.path.getsize(body["file"]), seconds=body["seconds"],
               events=len(trace.get("traceEvents", [])), kernel_events=len(kernels),
               cpu_op_events=len(cpu_ops),
               cpu_op_threads=len({e.get("tid") for e in cpu_ops}),
               b2_kernels=sum("paged_" in n for n in names),
               b1_kernels=sum("flash_prefill" in n for n in names),
               graph_launches=sum(e.get("name") == "cudaGraphLaunch"
                                  for e in trace.get("traceEvents", [])),
               captures_in_window=int(m1["decode_graph_captures"] - m0["decode_graph_captures"]),
               replays_in_window=int(m1["decode_graph_replays"] - m0["decode_graph_replays"]),
               chats_ok=sum(ok), chats=len(chats), parse_s=time.monotonic() - t_parse)
    out["capture_under_profiler_works"] = out["captures_in_window"] > 0 and all(ok)
    log("[observe profile] " + json.dumps(out))
    check(out["b2_kernels"] > 0 and out["replays_in_window"] > 0,
          f"observe profile: no B2 launch from a graph replay in the window's trace: {out}")
    check(out["b1_kernels"] > 0, f"observe profile: no B1 launch in the window's trace: {out}")
    return out


def _obs_journal_cost(eng) -> dict:
    """The 1b's paged decode with 8 slots, as graph replays: rounds of 8
    seeded top-p requests (96 new tokens), the journal on and off (None, as the
    JAX package's test sets it), five of each interleaved. The JAX test's
    gate: on <= 2 x off + 50 ms."""
    from localai_tpu_torch.engine.engine import GenRequest

    prompts = [[(7 * i + j) % 250 + 1 for j in range(20)] for i in range(8)]

    def round_() -> tuple[float, float]:
        m0, dt0 = eng.metrics(), eng._decode_time
        t0 = time.monotonic()
        # Seeded top-p: the sampler of the traced chats, whose 64-step
        # block the engine captured already.
        hs = [eng.submit(GenRequest(prompt_ids=p, max_new_tokens=OBSERVE_COST_NEW,
                                    ignore_eos=True, temperature=0.8, top_p=0.9, seed=i))
              for i, p in enumerate(prompts)]
        for h in hs:
            check(list(h)[-1].kind == "done", "observe journal cost: a request failed")
        wall = time.monotonic() - t0
        steps = eng.metrics()["decode_steps"] - m0["decode_steps"]
        return wall, (eng._decode_time - dt0) * 1e3 / max(steps, 1)

    saved = eng._journal
    warm = round_()  # every shape captured before timing
    on, off = [], []
    for _ in range(OBSERVE_COST_ROUNDS):
        eng._journal = None
        off.append(round_())
        eng._journal = saved
        on.append(round_())
    eng._journal = saved
    med = {k: statistics.median(w for w, _s in v) for k, v in (("on", on), ("off", off))}
    out = dict(round_s_on=med["on"], round_s_off=med["off"], ratio=med["on"] / med["off"],
               spread_s_on=max(w for w, _ in on) - min(w for w, _ in on),
               spread_s_off=max(w for w, _ in off) - min(w for w, _ in off),
               step_ms_on=statistics.median(s for _w, s in on),
               step_ms_off=statistics.median(s for _w, s in off),
               rounds=OBSERVE_COST_ROUNDS, new_tokens=OBSERVE_COST_NEW, slots=len(prompts),
               warm_round_s=warm[0], rounds_s_on=[w for w, _ in on],
               rounds_s_off=[w for w, _ in off])
    log("[observe journal cost] " + json.dumps(out))
    check(med["on"] <= 2.0 * med["off"] + 0.05,
          f"observe journal cost: a round with the journal on takes more than 2 x off + 50 ms: "
          f"{out}")
    return out


def _obs_quiesced(eng, label: str) -> None:
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with eng._pending_lock:
            busy = bool(eng._pending)
        if not busy and not any(s is not None for s in eng.slots) and not eng._chunkings:
            break
        time.sleep(0.02)
    time.sleep(0.05)
    check(len(eng._free_pages) == eng.ecfg.kv_pages and eng._host_bytes == 0
          and not any(eng._slot_pages),
          f"{label}: the pool is not accounted at quiesce: {len(eng._free_pages)} of "
          f"{eng.ecfg.kv_pages} pages free, host tier {eng._host_bytes} bytes")


def _obs_faults(params, cfg, tokenizer) -> dict:
    """Faults on the main path's engine (the served weights, a pool that
    swaps, prefix cache off): device_dispatch and control_commit each on a
    block shape not yet captured and on a replay (the requests fail, no
    graph is half built, the stream leaves capture mode, the same requests
    then give the same ids); then three seeds of a FaultSchedule over the
    dispatch, commit, allocator and swap sites with 16 requests each (a
    pool that preempts and swaps):
    every request ends, the pool is accounted, one fault_<site> journal
    event per injected fault."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.testing import faults

    def fresh():
        e = Engine(cfg, params, tokenizer, device="cuda",
                   engine_cfg=EngineConfig(**OBSERVE_FAULT_ENGINE))
        e.start()
        return e

    # One request: its admission fires device_dispatch twice (calls 1-2),
    # its first block a third time.
    short = [[(11 + j) % 250 + 1 for j in range(100)]]

    def run(e, reqs):
        hs = [e.submit(r) for r in reqs]
        evs = [list(h) for h in hs]
        return [ev[-1].kind for ev in evs], [[x.token_id for x in ev if x.kind == "token"]
                                             for ev in evs]

    greedy = [GenRequest(prompt_ids=p, max_new_tokens=20, ignore_eos=True) for p in short]
    t_seams = time.monotonic()
    eng = fresh()
    seams = {}
    try:
        for when, site, after in (("uncaptured", "device_dispatch", 2),
                                  ("uncaptured", "control_commit", 0),
                                  ("clean", None, 0),
                                  ("replay", "device_dispatch", 2),
                                  ("replay", "control_commit", 0),
                                  ("again", None, 0)):
            g0 = eng.metrics()["decode_graph_captures"]
            if site is None:
                kinds, ids = run(eng, greedy)
            else:
                with faults.active(faults.ChaosScript(0, [faults.ChaosPhase(site, after)],
                                                      threads={eng._thread.ident})):
                    kinds, ids = run(eng, greedy)
            g1 = eng.metrics()["decode_graph_captures"]
            _obs_quiesced(eng, f"observe faults {when} {site}")
            key = f"{when}_{site}" if site else when
            seams[key] = dict(kinds=kinds, captures=int(g1 - g0), graphs=len(eng._graph_cache))
            check(not torch.cuda.is_current_stream_capturing(),
                  f"observe faults {key}: the stream is left capturing")
            if site is None:
                check(kinds == ["done"], f"observe faults {key}: {kinds}")
                seams[key]["ids"] = ids
            else:
                check(kinds == ["error"] and g1 == g0,
                      f"observe faults {key}: {kinds}, {g1 - g0} captures")
        check(seams["clean"]["captures"] > 0 and seams["again"]["captures"] == 0
              and seams["again"]["ids"] == seams["clean"]["ids"],
              f"observe faults: the engine after the faults gives other ids or captures: "
              f"{ {k: (v['kinds'], v['captures']) for k, v in seams.items()} }")
        for v in seams.values():
            v.pop("ids", None)
    finally:
        eng.stop()
        eng.drop_device_state()
    seams_s = time.monotonic() - t_seams
    sweeps = []
    for seed in OBSERVE_FAULT_SEEDS:
        eng = fresh()
        try:
            sched = faults.FaultSchedule(seed, rate=0.05, sites=OBSERVE_FAULT_SITES,
                                         max_faults=6, site_rates=OBSERVE_FAULT_RATES,
                                         threads={eng._thread.ident})
            gen = torch.Generator().manual_seed(seed)
            reqs = [GenRequest(prompt_ids=torch.randint(0, 256, (n,), generator=gen).tolist(),
                               max_new_tokens=OBSERVE_FAULT_NEW, ignore_eos=True,
                               temperature=0.0 if i % 2 == 0 else 0.8, top_p=0.9, seed=i)
                    for i, n in enumerate(OBSERVE_FAULT_PROMPTS)]
            kinds: list = [None] * len(reqs)

            def drain(i, h):
                kinds[i] = list(h)[-1].kind

            t0 = time.monotonic()
            with faults.active(sched):
                threads = [threading.Thread(target=drain, args=(i, eng.submit(r)))
                           for i, r in enumerate(reqs)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=max(1.0, OBSERVE_DEADLINE_S - (time.monotonic() - t0)))
                wall = time.monotonic() - t0
                check(all(not th.is_alive() for th in threads) and wall <= OBSERVE_DEADLINE_S,
                      f"observe faults seed {seed}: a request did not end within "
                      f"{OBSERVE_DEADLINE_S} s")
                _obs_quiesced(eng, f"observe faults seed {seed}")
            snap = eng.journal.snapshot()
            journaled = {s: sum(e["event"] == f"fault_{s}" for e in snap)
                         for s in OBSERVE_FAULT_SITES}
            fired = {s: sched.fired[s] for s in OBSERVE_FAULT_SITES}
            m = eng.metrics()
            row = dict(seed=seed, requests=len(reqs), done=kinds.count("done"),
                       error=kinds.count("error"), wall_s=wall, fired=fired,
                       calls={s: sched.calls[s] for s in OBSERVE_FAULT_SITES},
                       preemptions=int(m["kv_preemptions"]),
                       swaps=int(m["kv_preempt_swaps"]), captures=int(m["decode_graph_captures"]))
            sweeps.append(row)
            check(all(k in ("done", "error") for k in kinds),
                  f"observe faults seed {seed}: {kinds}")
            check(journaled == fired,
                  f"observe faults seed {seed}: journal {journaled} != injected {fired}")
        finally:
            eng.stop()
            eng.drop_device_state()
    check(sum(r["fired"][s] for r in sweeps for s in OBSERVE_FAULT_SITES) > 0
          and sum(r["preemptions"] for r in sweeps) > 0,
          f"observe faults: the three seeds injected no fault or never preempted: {sweeps}")
    out = dict(seams=seams, seams_s=seams_s, sweeps=sweeps,
               fired_by_site={s: sum(r["fired"][s] for r in sweeps) for s in OBSERVE_FAULT_SITES})
    log("[observe faults] " + json.dumps(out))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _obs_memory() -> dict:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(allocated_gib=torch.cuda.memory_allocated() / 2**30,
                reserved_gib=torch.cuda.memory_reserved() / 2**30)


def _obs_restarts(base: str, manager, pm_dir: str) -> dict:
    """engine_loop faults kill the served engine's loop three times with a
    restart budget of 2: each death leaves a postmortem naming the dead
    requests and the loop_dead gauge's postmortem label before the reap;
    the first two restart transparently, the third quarantines (503 with
    Retry-After) until the quarantine expires; memory after each restart.
    Last, a fourth death with no traffic: the watchdog reaps it."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.testing import faults

    chat = {"model": "obs-1b", "max_tokens": 8, "ignore_eos": True,
            "messages": [{"role": "user", "content": "after the death"}]}

    def kill(eng, cycle: int, traffic: bool) -> dict:
        # The dying requests are mid-admission: 3000-token prompts whose
        # chunks hold slots and pages (a restarted engine would otherwise
        # spend the kill capturing its first 64-step block's graph).
        hs = []
        if traffic:
            hs = [eng.submit(GenRequest(prompt_ids=[(cycle * 31 + i * 7 + j) % 250 + 1
                                                    for j in range(3000)],
                                        max_new_tokens=64, ignore_eos=True,
                                        request_id=f"death-{cycle}-{i}")) for i in range(2)]
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and sum(
                    s is not None for s in eng.slots) < 2:
                time.sleep(0.002)
        with faults.active(faults.FaultSchedule(cycle, rate=1.0, sites=("engine_loop",),
                                                max_faults=1, threads={eng._thread.ident})):
            eng._wake.set()
            deadline = time.monotonic() + 60
            while not eng.is_dead and time.monotonic() < deadline:
                time.sleep(0.01)
            check(eng.is_dead, f"observe restart {cycle}: the engine_loop fault did not kill it")
            eng._thread.join(timeout=60)
        kinds = [list(h)[-1].kind for h in hs]
        check(all(k == "error" for k in kinds), f"observe restart {cycle}: {kinds}")
        check(len(eng._free_pages) == eng.ecfg.kv_pages and eng._host_bytes == 0,
              f"observe restart {cycle}: the dead engine's pool is not released")
        pm_path = eng.postmortem_path
        check(pm_path.startswith(pm_dir) and os.path.isfile(pm_path),
              f"observe restart {cycle}: no postmortem in {pm_dir}: {pm_path!r}")
        with open(pm_path) as f:
            pm = json.load(f)
        named = {s["rid"] for s in pm["slots"]} | set(pm["pending"])
        want = {f"death-{cycle}-{i}" for i in range(len(hs))}
        check(want <= named and pm["pool"]["free_pages"] == eng.ecfg.kv_pages,
              f"observe restart {cycle}: the postmortem names {sorted(named)}, not {sorted(want)}")
        st, _h, metrics = _http_call(base, "GET", "/metrics")
        line = f'localai_engine_loop_dead{{model="obs-1b",postmortem="{pm_path}"}} 1.0'
        check(st == 200 and line in metrics,
              f"observe restart {cycle}: /metrics lacks the loop_dead gauge's postmortem label")
        return dict(postmortem=os.path.basename(pm_path), dead_requests=sorted(named),
                    journal_tail=len(pm["journal"]), postmortem_bytes=os.path.getsize(pm_path))

    def settle(old) -> None:
        deadline = time.monotonic() + 60  # the reaped engine's teardown thread
        while old.params is not None and time.monotonic() < deadline:
            time.sleep(0.05)

    cycles = []
    for cycle in (1, 2, 3):
        old = manager.get("obs-1b").engine
        t_kill = time.monotonic()
        row = dict(cycle=cycle, **kill(old, cycle, traffic=True))
        row["kill_s"] = time.monotonic() - t_kill
        t0 = time.monotonic()
        st, hdrs, body = _http_call(base, "POST", "/v1/chat/completions", chat)
        row.update(status=st, chat_after_death_s=time.monotonic() - t0)
        if cycle < 3:
            check(st == 200, f"observe restart {cycle}: HTTP {st} after the death: {body}")
        else:
            row["retry_after"] = hdrs.get("Retry-After")
            check(st == 503 and int(hdrs.get("Retry-After", "0")) >= 1,
                  f"observe restart 3: HTTP {st} (Retry-After {hdrs.get('Retry-After')}), "
                  f"not a 503 quarantine: {body}")
            time.sleep(OBSERVE_APP["quarantine_s"] + 0.5)
            st, _h, body = _http_call(base, "POST", "/v1/chat/completions", chat)
            row["status_after_quarantine"] = st
            check(st == 200, f"observe restart 3: HTTP {st} once the quarantine expired")
        t_settle = time.monotonic()
        settle(old)
        del old
        row.update(_obs_memory(), stats=manager.restart_stats("obs-1b"),
                   settle_s=time.monotonic() - t_settle)
        log("[observe restart] " + json.dumps(row))
        cycles.append(row)
    check(abs(cycles[2]["allocated_gib"] - cycles[0]["allocated_gib"])
          <= 0.05 * cycles[0]["allocated_gib"],
          f"observe restart: allocated memory after the third cycle "
          f"{cycles[2]['allocated_gib']:.3f} GiB is not within 5 % of the first's "
          f"{cycles[0]['allocated_gib']:.3f}")
    # A death with no traffic: the watchdog reaps it.
    old = manager.get("obs-1b").engine
    kill(old, 4, traffic=False)
    manager.app_cfg.watchdog_interval_s = 0.2
    manager.app_cfg.watchdog_busy_timeout_s = 3600.0
    t0 = time.monotonic()
    manager.ensure_watchdog()
    while manager.peek("obs-1b") is not None and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    reaped_s = time.monotonic() - t0
    check(manager.peek("obs-1b") is None, "observe: the watchdog never reaped the dead engine")
    settle(old)
    del old
    stats = manager.restart_stats("obs-1b")
    check(stats["restarts_total"] == 4, f"observe: restart stats {stats}")
    return dict(cycles=cycles, watchdog_reap_s=reaped_s, stats=stats,
                memory_after=_obs_memory())


def phase_observe() -> dict:
    """llama-3.2-1b bf16 at full width, 4 of its 16 layers, on the paged
    config, served by ModelManager and the port's HTTP server with the
    journal (4096 events), trace_fence, a postmortem directory and a
    profile directory: traces, the timeline, a profile window, the
    journal's cost, faults, and crash-only restart and quarantine."""
    import yaml

    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server

    out = {}
    with tempfile.TemporaryDirectory() as root:
        pm_dir, prof_dir = f"{root}/postmortems", f"{root}/profiles"
        with open(f"{root}/obs-1b.yaml", "w") as f:
            yaml.safe_dump(OBSERVE_YAML, f)
        app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=root,
                                trace_fence=True, postmortem_dir=pm_dir, profile_dir=prof_dir,
                                **OBSERVE_APP)
        manager = ModelManager(app, device="cuda")
        router = Router()
        OpenAIApi(manager).register(router)
        server = create_server(app, router)
        threading.Thread(target=server.serve_forever, daemon=True, name="http").start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        seconds = {}

        def part(name, fn, *args):
            t0 = time.monotonic()
            out[name] = fn(*args)
            seconds[name] = round(time.monotonic() - t0, 1)

        try:
            t0 = time.monotonic()
            eng = manager.get("obs-1b").engine
            seconds["load"] = round(time.monotonic() - t0, 1)
            check(eng._trace_fence and eng.journal.capacity == 4096
                  and eng.ecfg.postmortem_dir == pm_dir,
                  "observe: the server's observability settings did not reach the engine")
            part("traces", _obs_traces, base, eng)
            part("timeline", _obs_timeline, base)
            part("profile", _obs_profile, base, eng, prof_dir)
            part("journal_cost", _obs_journal_cost, eng)
            st, _h, sysinfo = _http_call(base, "GET", "/system")
            check(st == 200 and sysinfo["sysinfo"]["device_count"] >= 1
                  and sysinfo["backends"]["obs-1b"]["loop_dead"] == 0.0,
                  f"observe: /system answered {st}")
            out["system"] = dict(devices=sysinfo["devices"],
                                 memory_free_gib=sysinfo["sysinfo"]["devices"][0][
                                     "memory_free_bytes"] / 2**30)
            part("faults", _obs_faults, eng.params, eng.cfg, eng.tokenizer)
            del eng
            part("restarts", _obs_restarts, base, manager, pm_dir)
            out["seconds"] = seconds
        finally:
            server.shutdown()
            manager.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    summary = {k: {kk: vv for kk, vv in v.items() if kk != "run"} for k, v in out.items()}
    log(json.dumps({"observe": summary}))
    return out


# Embeddings, rerank, the bert backend and the vector store (phase 24).
# llama-3.2-1b bf16 at full width, 4 of its 16 layers, on the paged config, the byte
# tokenizer (ASCII text round-trips to its ids), no speculation; the chats,
# rerank and embeddings all on one model.
EMBED_YAML = dict({k: v for k, v in LORA_BASE_YAML.items() if k != "tokenizer"},
                  name="emb-1b", spec_mode="off",
                  known_usecases=["chat", "completion", "embeddings", "rerank", "tokenize"])
EMBED_LENS = [20, 45, 80, 130, 200, 290, 380, 500]  # 8 strings and 8 token arrays
EMBED_COS_MIN = 0.999  # each bf16 vector against its f32 witness
EMBED_NORM_TOL = 1e-3
EMBED_CHATS = [60, 200, 400, 900, 60, 200, 400, 1400]
EMBED_CHAT_NEW = 512  # eight 64-step blocks a chat: the embed and the rerank land between
RERANK_CONT = 32  # tokens of the greedy continuation, and of each other document
RERANK_TOL = 2e-2  # |bf16 score - f32 witness score|
RERANK_LONG = (32, 1000, 1000)  # documents, query and document tokens: bucket 2048
CARD_CPU_TOL = 1e-4  # f32 on the card against the CPU
BGE_INPUTS = 32
MINILM = dict(name="ms-marco-MiniLM-L-6-v2", vocab_size=30522, hidden_size=384, num_layers=6,
              num_heads=12, intermediate_size=1536, max_position=512, num_labels=1)
STORE_KEYS, STORE_DIM, STORE_FINDS, STORE_K = 100_000, 384, 100, 10
STORE_SIM_TOL = 1e-5


def _f32_tree(params: dict) -> dict:
    return {k: (_f32_tree(v) if isinstance(v, dict) else v.float()) for k, v in params.items()}


def _to_cuda(params: dict) -> dict:
    return {k: (_to_cuda(v) if isinstance(v, dict) else v.cuda()) for k, v in params.items()}


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _er_inputs(vocab: int) -> list:
    """16 embedding inputs of 20-500 tokens: ASCII strings and token arrays
    of random ids, interleaved."""
    rng = np.random.default_rng(21)
    strings = [_obs_text(n, 300 + i) for i, n in enumerate(EMBED_LENS)]
    arrays = [rng.integers(0, vocab, n).tolist() for n in EMBED_LENS]
    return [x for pair in zip(strings, arrays) for x in pair]


def _er_chats(base: str, eng) -> tuple[list, list]:
    """8 streamed greedy chats of EMBED_CHAT_NEW tokens, started now; returns
    (threads, results) with each result's status, frames, frame arrival
    times and end time."""
    results: list = [None] * len(EMBED_CHATS)

    def run(i, n):
        body = {"model": "emb-1b", "messages": [{"role": "user", "content": _obs_text(n, 800 + i)}],
                "max_tokens": EMBED_CHAT_NEW, "ignore_eos": True, "temperature": 0.0,
                "stream": True}
        stamps: list = []
        res = _http(base, "/v1/chat/completions", body, time.monotonic(), stamps)
        results[i] = dict(res, stamps=stamps, t_done=time.monotonic())

    threads = [threading.Thread(target=run, args=(i, n), daemon=True)
               for i, n in enumerate(EMBED_CHATS)]
    for th in threads:
        th.start()
    return threads, results


def _er_llama(base: str, manager) -> dict:
    """(a) the 1b through the server: /v1/embeddings, /v1/rerank (the
    greedy continuation among 7 random documents), the same embeddings
    again under 8 streamed chats, a 32-document rerank at bucket 2048 (its
    peak memory); then the f32 witnesses on the same weights."""
    from localai_tpu_torch.engine.engine import GenRequest, pad_rows
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.ops import attention
    from localai_tpu_torch.ops.flash import flash_prefill_attention_plain

    out: dict = {}
    t0 = time.monotonic()
    eng = manager.get("emb-1b").engine
    torch.cuda.synchronize()  # the random draw is queued on the card
    out["load_s"] = time.monotonic() - t0
    cfg, tok = eng.cfg, eng.tokenizer
    inputs = _er_inputs(cfg.vocab_size)
    ids = [tok.encode(x) if isinstance(x, str) else list(x) for x in inputs]
    check([len(i) for i in ids] == [n for n in EMBED_LENS for _ in (0, 1)],
          "embed_rerank: input lengths")
    # The model's own greedy continuation of the query, among printable
    # ASCII ids (a +100 bias on each), so its text encodes back to its ids.
    query = _obs_text(60, 400)
    q_ids = tok.encode(query)
    cont, final = eng.submit(GenRequest(
        prompt_ids=q_ids, max_new_tokens=RERANK_CONT, temperature=0.0, ignore_eos=True,
        logit_bias={i: 100.0 for i in range(32, 127)})).result()
    check(final.kind == "done" and len(tok.encode(cont)) == RERANK_CONT,
          f"embed_rerank: the greedy continuation {cont!r}")
    docs = [_obs_text(RERANK_CONT, 500 + i) for i in range(7)]
    docs.insert(5, cont)

    def post(path, body):
        t = time.monotonic()
        st, _h, resp = _http_call(base, "POST", path, body)
        check(st == 200, f"embed_rerank: {path} answered {st}: {resp}")
        return resp, (time.monotonic() - t) * 1e3

    # Run 1: embeddings and rerank on an idle engine, each twice (the first
    # call at a shape pays cuBLAS's and the allocator's first-use costs).
    _zero_counts()
    e1, out["embed_ms_first"] = post("/v1/embeddings", {"model": "emb-1b", "input": inputs})
    rr, out["rerank_ms_first"] = post("/v1/rerank", {"model": "emb-1b", "query": query,
                                                      "documents": docs})
    e1b, out["embed_ms"] = post("/v1/embeddings", {"model": "emb-1b", "input": inputs})
    rrb, out["rerank_ms"] = post("/v1/rerank", {"model": "emb-1b", "query": query,
                                                 "documents": docs})
    run1 = _read_counts()
    check(run1["flash_prefill"] == 4 * cfg.num_layers,
          f"embed_rerank: {run1['flash_prefill']} B1 launches for two embeds and two reranks "
          f"(want {4 * cfg.num_layers})")
    check(e1b["data"] == e1["data"] and rrb["results"] == rr["results"],
          "embed_rerank: a repeated embed or rerank differs")
    vecs = [d["embedding"] for d in e1["data"]]
    norms = [float(np.linalg.norm(v)) for v in vecs]
    check(len(vecs) == 16 and all(len(v) == cfg.hidden_size for v in vecs)
          and max(abs(n - 1.0) for n in norms) <= EMBED_NORM_TOL,
          f"embed_rerank: 16 vectors of {cfg.hidden_size}, norms {norms}")
    check(e1["usage"]["prompt_tokens"] == sum(len(i) for i in ids), "embed_rerank: usage")
    order = [r["index"] for r in rr["results"]]
    check(order[0] == 5, f"embed_rerank: the greedy continuation ranked {order.index(5) + 1}: "
                         f"{rr['results']}")
    scores = {r["index"]: r["relevance_score"] for r in rr["results"]}

    # Run 2: the 32-document rerank at bucket 2048 on the idle engine (its
    # peak memory), then the same embeddings and the same rerank while 8
    # streamed chats decode, then the rerank warm and idle again.
    _zero_counts()
    n, qn, dn = RERANK_LONG
    long_q, long_docs = _obs_text(qn, 600), [_obs_text(dn, 700 + i) for i in range(n)]
    long_body = {"model": "emb-1b", "query": long_q, "documents": long_docs}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rl, out["rerank32_ms_first"] = post("/rerank", long_body)
    out["rerank32_peak_extra_gib"] = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    threads, chats = _er_chats(base, eng)
    # Every chat admitted and one block after: the block shapes' graph
    # captures are behind, so the gaps below hold the calls, not them.
    t_wait, blocks_full = time.monotonic() + 300, None
    while time.monotonic() < t_wait:
        if blocks_full is None and int(eng.h_active.sum()) == len(EMBED_CHATS):
            blocks_full = eng.m_blocks
        if blocks_full is not None and eng.m_blocks > blocks_full:
            break
        time.sleep(0.005)
    active = int(eng.h_active.sum())
    captures0 = eng.m_graph_captures
    t_full = t_e = time.monotonic()
    e2, out["embed_busy_ms"] = post("/v1/embeddings", {"model": "emb-1b", "input": inputs})
    t_e2 = t_r = time.monotonic()
    rl2, out["rerank32_busy_ms"] = post("/rerank", long_body)
    t_r2 = time.monotonic()
    out["captures_during_calls"] = eng.m_graph_captures - captures0
    for th in threads:
        th.join(timeout=600)
    check(all(not th.is_alive() for th in threads), "embed_rerank: a chat never finished")
    for i, c in enumerate(chats):
        check(c["status"] == 200 and c["frames"][-1] == "[DONE]",
              f"embed_rerank: chat {i} answered {c['status']}")
        usage = json.loads(c["frames"][-2])["usage"]
        check(usage["completion_tokens"] == EMBED_CHAT_NEW, f"embed_rerank: chat {i}: {usage}")
    out["chats_active_at_embed"] = active
    out["chats_after_embed"] = sum(c["t_done"] > t_e2 for c in chats)
    out["chats_after_rerank32"] = sum(c["t_done"] > t_r2 for c in chats)
    check(active > 0 and out["chats_after_embed"] > 0 and out["chats_after_rerank32"] > 0,
          f"embed_rerank: the calls did not overlap the chats ({active} active, "
          f"{out['chats_after_embed']} / {out['chats_after_rerank32']} ended after the "
          f"embed / the rerank)")
    same = [d["embedding"] for d in e2["data"]] == vecs
    out["busy_bit_identical"] = same
    check(same, "embed_rerank: the embeddings under 8 streamed chats differ from the idle run")
    check(rl2["results"] == rl["results"],
          "embed_rerank: the 32-document rerank under 8 streamed chats differs from the idle run")
    # The chats' inter-token gaps once all are admitted: frames come a
    # decode block at a time, so the gaps of 20 ms or more are the
    # block-to-block ones. A gap that overlaps a call's window holds that
    # call's forward (the loop runs it between two blocks).
    block_gaps, embed_gaps, rerank_gaps = [], [], []
    for c in chats:
        st = c["stamps"][:-1]  # the [DONE] frame follows the last token's
        for t0_, t1_ in zip(st, st[1:]):
            if t1_ - t0_ < 0.020 or t1_ < t_full:
                continue
            gap = (t1_ - t0_) * 1e3
            if t0_ <= t_e2 and t1_ >= t_e:
                embed_gaps.append(gap)
            elif t0_ <= t_r2 and t1_ >= t_r:
                rerank_gaps.append(gap)
            else:
                block_gaps.append(gap)
    out["chat_gap_block_ms_p50"] = float(np.median(block_gaps)) if block_gaps else None
    out["chat_gap_block_ms_max"] = max(block_gaps, default=None)
    out["chat_gap_embed_ms_max"] = max(embed_gaps, default=None)
    out["chat_gap_rerank32_ms_max"] = max(rerank_gaps, default=None)
    check(embed_gaps and rerank_gaps and block_gaps,
          f"embed_rerank: no chat gap overlaps the busy embed ({len(embed_gaps)}) or the "
          f"rerank ({len(rerank_gaps)}), or none lies between ({len(block_gaps)})")
    rl3, out["rerank32_ms"] = post("/rerank", long_body)
    run2 = _read_counts()
    check(rl3["results"] == rl["results"], "embed_rerank: a repeated 32-document rerank differs")
    jobs = eng.metrics()
    out["loop_jobs"], out["loop_jobs_ms_total"] = jobs["loop_jobs"], jobs["loop_jobs_ms_total"]
    # The same batch's forward alone (no unembed), on this thread while the
    # loop idles: the chunked unembed's share of the call.
    rows32 = [tok.encode(long_q) + tok.encode(d) for d in long_docs]
    toks32, lens32 = pad_rows(rows32, 2048)
    t32, l32 = torch.from_numpy(toks32).to(eng.device), torch.from_numpy(lens32).to(eng.device)
    out["rerank32_forward_ms"] = cuda_time_ms(
        lambda: llama._forward_hidden(cfg, eng.params, t32, l32, collect_kv=False), 2, warmup=1)
    del t32, l32
    S = 2048
    check(eng._bucket_for(qn + dn) == S and len(rl["results"]) == n,
          "embed_rerank: the 32-document rerank")
    # The reference's log_softmax over [N, S-1, V] f32, and its logits beside.
    out["rerank32_unchunked_gib"] = 2 * n * (S - 1) * cfg.vocab_size * 4 / 2**30
    out["rerank32_chunk_bytes"] = llama.LOGPROB_CHUNK_ROWS * cfg.vocab_size * 4
    check(run2["flash_prefill"] >= 4 * cfg.num_layers,
          f"embed_rerank: {run2['flash_prefill']} B1 launches in the busy run")

    # The f32 witnesses: the same ids through the same functions on an f32
    # copy of the served weights, on the card, with attention on B1's plain
    # version (no kernel of the port in the witness).
    cfg32, p32 = dataclasses.replace(cfg, dtype="float32"), _f32_tree(eng.params)
    toks, lens = pad_rows(ids, eng._bucket_for(max(len(i) for i in ids)))
    dev = eng.device

    def plain_attn():
        return swapped(attention, "flash_prefill_attention", flash_prefill_attention_plain)

    before = _read_counts()["flash_prefill"]
    with plain_attn():
        w = llama.encode(cfg32, p32, torch.from_numpy(toks).to(dev),
                         torch.from_numpy(lens).to(dev)).cpu().numpy()
    cos = [_cosine(v, w[i]) for i, v in enumerate(vecs)]
    out["embed_cos_min"] = min(cos)
    check(min(cos) >= EMBED_COS_MIN, f"embed_rerank: bf16 vs f32 cosines {cos}")
    rows = [q_ids + tok.encode(d) for d in docs]
    toks, lens = pad_rows(rows, eng._bucket_for(max(len(r) for r in rows)))
    conds = torch.full((len(rows),), len(q_ids), dtype=torch.int64, device=dev)
    with plain_attn():
        ws = llama.sequence_logprob(cfg32, p32, torch.from_numpy(toks).to(dev),
                                    torch.from_numpy(lens).to(dev), conds).cpu().numpy()
    check(_read_counts()["flash_prefill"] == before, "embed_rerank: a witness launched B1")
    out["rerank_err"] = max(abs(scores[i] - float(ws[i])) for i in range(len(docs)))
    out["rerank_scores"] = [scores[i] for i in range(len(docs))]
    out["rerank_witness_first"] = int(np.argmax(ws))
    check(out["rerank_err"] <= RERANK_TOL,
          f"embed_rerank: rerank scores {out['rerank_scores']} vs f32 {ws.tolist()}")
    del p32
    torch.cuda.empty_cache()
    out["runs"] = {"embed_rerank": {"launches": run1}, "embed_rerank_busy": {"launches": run2}}
    return out


def _er_tiny() -> dict:
    """(b) llama.encode and sequence_logprob on tiny-d64 f32 on the card
    (B1's f32 kernel; int8 weights: B3 and B4's f32 kernels) against the
    same functions on the CPU."""
    from localai_tpu_torch.models import get_arch, llama
    from localai_tpu_torch.models.quant import quantize_params

    cfg = dataclasses.replace(get_arch("tiny"), name="tiny-d64", hidden_size=256,
                              intermediate_size=512, num_heads=4, num_kv_heads=2,
                              dtype="float32")
    p_cpu = llama.init_params(cfg, seed=7, scale=0.06, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 64))).long()
    lens, conds = torch.tensor([64, 23, 1]), torch.tensor([10, 4, 0])
    out = {}
    for name, p in (("plain", p_cpu), ("int8", quantize_params(cfg, p_cpu, "int8"))):
        p_gpu = _to_cuda(p)
        want = (llama.encode(cfg, p, toks, lens), llama.sequence_logprob(cfg, p, toks, lens, conds))
        _zero_counts()
        got = (llama.encode(cfg, p_gpu, toks.cuda(), lens.cuda()),
               llama.sequence_logprob(cfg, p_gpu, toks.cuda(), lens.cuda(), conds.cuda()))
        launches = _read_counts()
        err = max((g.cpu() - w).abs().max().item() for g, w in zip(got, want))
        out[name] = dict(max_abs_err=err, launches=launches)
        check(err <= CARD_CPU_TOL, f"embed_rerank tiny {name}: card vs CPU {err}")
        check(launches["flash_prefill"] == 2 * cfg.num_layers,
              f"embed_rerank tiny {name}: {launches['flash_prefill']} B1 launches")
        if name == "int8":
            check(launches["quant_matmul"] == 2 * 7 * cfg.num_layers
                  and launches["quant_unembed"] == 1,
                  f"embed_rerank tiny int8: B3 {launches['quant_matmul']}, "
                  f"B4 {launches['quant_unembed']} launches")
    return out


def _er_bert(base: str, manager, root: str) -> dict:
    """(c) bge-large embeds 32 inputs over HTTP, the 4 shortest held to the
    CPU; (d) the MiniLM cross-encoder reranks 16 documents over HTTP, held
    to the CPU."""
    from localai_tpu_torch.engine.bert_engine import BertEngine
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import bert as B

    out: dict = {}
    t0 = time.monotonic()
    eng = manager.get("bge-large").engine
    torch.cuda.synchronize()
    out["bge_load_s"] = time.monotonic() - t0
    bcfg = eng.cfg
    rng = np.random.default_rng(5)
    lens = rng.integers(8, 500, BGE_INPUTS).tolist()
    inputs = [(_obs_text(n, 900 + i) if i % 2 else rng.integers(0, bcfg.vocab_size, n).tolist())
              for i, n in enumerate(lens)]
    t = time.monotonic()
    st, _h, body = _http_call(base, "POST", "/v1/embeddings", {"model": "bge-large",
                                                               "input": inputs})
    out["bge_batch_ms"] = (time.monotonic() - t) * 1e3
    check(st == 200, f"embed_rerank bge-large: {st} {body}")
    vecs = np.asarray([d["embedding"] for d in body["data"]], np.float32)
    check(vecs.shape == (BGE_INPUTS, 1024)
          and np.abs(np.linalg.norm(vecs, axis=-1) - 1).max() <= 1e-4,
          f"embed_rerank bge-large: {vecs.shape}")
    out["bge_busy_ms"] = eng.metrics()["busy_seconds"] * 1e3
    short = sorted(range(BGE_INPUTS), key=lambda i: lens[i])[:4]
    cpu = BertEngine(bcfg, B.load_hf_bert(bcfg, f"{root}/ckpt-bge-large", device="cpu"),
                     ByteTokenizer(bcfg.vocab_size))
    tok = eng.tokenizer
    want = cpu.embed([tok.encode(inputs[i]) if isinstance(inputs[i], str) else inputs[i]
                      for i in short])
    out["bge_card_cpu_err"] = float(np.abs(vecs[short] - want).max())
    check(out["bge_card_cpu_err"] <= CARD_CPU_TOL,
          f"embed_rerank bge-large: card vs CPU {out['bge_card_cpu_err']}")
    del cpu
    t0 = time.monotonic()
    ce = manager.get("minilm-reranker").engine
    out["minilm_load_s"] = time.monotonic() - t0
    query = _obs_text(40, 950)
    docs = [_obs_text(int(n), 960 + i) for i, n in enumerate(rng.integers(10, 300, 16))]
    t = time.monotonic()
    st, _h, body = _http_call(base, "POST", "/v1/rerank", {"model": "minilm-reranker",
                                                           "query": query, "documents": docs})
    out["minilm_rerank_ms"] = (time.monotonic() - t) * 1e3
    check(st == 200 and len(body["results"]) == 16, f"embed_rerank minilm: {st} {body}")
    got = np.zeros(16, np.float32)
    for r in body["results"]:
        got[r["index"]] = r["relevance_score"]
    cpu = BertEngine(ce.cfg, B.load_hf_bert(ce.cfg, f"{root}/ckpt-minilm", device="cpu"),
                     ByteTokenizer(ce.cfg.vocab_size))
    want = cpu.rerank(ce.tokenizer.encode(query), [ce.tokenizer.encode(d) for d in docs])
    out["minilm_card_cpu_err"] = float(np.abs(got - want).max())
    check(out["minilm_card_cpu_err"] <= CARD_CPU_TOL,
          f"embed_rerank minilm: card vs CPU {out['minilm_card_cpu_err']}")
    return out


def _er_store(base: str, registry) -> dict:
    """(e) 100,000 keys x 384 f32 on the card: 100 finds at k = 10 against
    numpy (indices and order, similarities within 1e-5); ms a find. Then
    /stores/* over HTTP on a small store."""
    rng = np.random.default_rng(11)
    keys = rng.standard_normal((STORE_KEYS, STORE_DIM)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    store = registry.get("bench")
    t = time.monotonic()
    store.set(keys, [str(i).encode() for i in range(STORE_KEYS)])
    out = {"set_s": time.monotonic() - t, "device_bytes": store._dev_keys.numel() * 4}
    check(store._dev_keys.is_cuda and out["device_bytes"] == STORE_KEYS * STORE_DIM * 4,
          "embed_rerank store: the keys are not on the card")
    queries = rng.standard_normal((STORE_FINDS, STORE_DIM)).astype(np.float32)
    found = []
    store.find(queries[0], STORE_K)  # the first call loads cuBLAS
    torch.cuda.synchronize()
    t = time.monotonic()
    for q in queries:
        found.append(store.find(q, STORE_K))
    out["find_ms"] = (time.monotonic() - t) * 1e3 / STORE_FINDS
    err, same = 0.0, True
    for q, (_k, values, sims) in zip(queries, found):
        ref = keys @ (q / np.linalg.norm(q))
        idx = np.argsort(-ref, kind="stable")[:STORE_K]
        same &= [int(v) for v in values] == idx.tolist()
        err = max(err, float(np.abs(sims - ref[idx]).max()))
    out.update(indices_equal=same, sim_err=err)
    check(same and err <= STORE_SIM_TOL,
          f"embed_rerank store: indices equal {same}, similarity error {err}")
    st, _h, _b = _http_call(base, "POST", "/stores/set", {
        "store": "http", "keys": [[1, 0, 0], [0, 1, 0], [0.6, 0.8, 0]], "values": ["a", "b", "c"]})
    st2, _h, found_http = _http_call(base, "POST", "/stores/find", {"store": "http",
                                                                    "key": [1, 0, 0], "topk": 2})
    check(st == st2 == 200 and found_http["values"] == ["a", "c"],
          f"embed_rerank store: /stores/find answered {st2} {found_http}")
    return out


def phase_embed_rerank() -> dict:
    """Embeddings, rerank, the bert backend and the vector store through
    ModelManager and the port's HTTP server (OpenAIApi, RerankApi,
    StoresApi): (a) llama-3.2-1b, (b) tiny-d64 card vs CPU, (c)
    bge-large, (d) the MiniLM cross-encoder, (e) the 100k-key store."""
    import yaml

    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.models import bert as B
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.rerank_api import RerankApi
    from localai_tpu_torch.server.stores_api import StoresApi
    from localai_tpu_torch.stores import StoreRegistry

    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        bge = B.BERT_PRESETS["bge-large"]
        B.save_hf_bert(bge, B.init_params(bge, seed=1, device="cuda"), f"{root}/ckpt-bge-large")
        mini = B.BertConfig(**MINILM)
        B.save_hf_bert(mini, B.init_params(mini, seed=2, scale=0.1, device="cuda"),
                       f"{root}/ckpt-minilm")
        seconds["write_checkpoints"] = round(time.monotonic() - t0, 1)
        for doc in (EMBED_YAML,
                    {"name": "bge-large", "backend": "bert", "model": "ckpt-bge-large"},
                    {"name": "minilm-reranker", "backend": "bert", "model": "ckpt-minilm"}):
            with open(f"{root}/{doc['name']}.yaml", "w") as f:
                yaml.safe_dump(doc, f)
        app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=root)
        manager = ModelManager(app, device="cuda")
        registry = StoreRegistry(device="cuda")
        router = Router()
        oai = OpenAIApi(manager)
        oai.register(router)
        RerankApi(manager, oai).register(router)
        StoresApi(registry).register(router)
        server = create_server(app, router)
        threading.Thread(target=server.serve_forever, daemon=True, name="http").start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def part(name, fn, *args):
            t = time.monotonic()
            out[name] = fn(*args)
            seconds[name] = round(time.monotonic() - t, 1)

        try:
            part("llama", _er_llama, base, manager)
            manager.unload("emb-1b", drain_s=0.0)
            part("tiny", _er_tiny)
            part("bert", _er_bert, base, manager, root)
            part("store", _er_store, base, registry)
            out["seconds"] = seconds
        finally:
            server.shutdown()
            manager.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    out["runs"] = {**out["llama"].pop("runs"),
                   **{f"embed_rerank_tiny_{k}": {"launches": v["launches"]}
                      for k, v in out["tiny"].items()}}
    log(json.dumps({"embed_rerank": {k: v for k, v in out.items() if k != "runs"}}))
    return out


# --------------------------------------------------------------------------- #
# 25. vision: Qwen2-VL-2B and llava over HTTP, the tiny Qwen2-VL card vs CPU
# --------------------------------------------------------------------------- #

# Qwen/Qwen2-VL-2B-Instruct's published config.json (widths, depths, rope).
QWEN2_VL_2B = {
    "model_type": "qwen2_vl", "architectures": ["Qwen2VLForConditionalGeneration"],
    "vocab_size": 151936, "hidden_size": 1536, "intermediate_size": 8960,
    "num_hidden_layers": 28, "num_attention_heads": 12, "num_key_value_heads": 2,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
    "tie_word_embeddings": True, "hidden_act": "silu",
    "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
    "bos_token_id": 151643, "eos_token_id": 151645, "image_token_id": 151655,
    "vision_start_token_id": 151652, "vision_end_token_id": 151653,
    "vision_config": {"depth": 32, "embed_dim": 1280, "mlp_ratio": 4, "num_heads": 16,
                      "in_chans": 3, "hidden_size": 1536, "patch_size": 14,
                      "spatial_merge_size": 2, "temporal_patch_size": 2},
}
# The CPU tests' tiny Qwen2-VL (tests/test_torch_qwen2_vl.py), f32, its
# decoder widened to head dim 64 (B1 takes 64 and 128; the tests' is 16).
QWEN2_VL_TINY = {
    "model_type": "qwen2_vl", "vocab_size": 300, "hidden_size": 256, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "max_position_embeddings": 512, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "hidden_act": "silu",
    "rope_scaling": {"type": "mrope", "mrope_section": [8, 12, 12]},
    "vision_config": {"depth": 2, "embed_dim": 32, "num_heads": 2, "mlp_ratio": 2,
                      "in_channels": 3, "patch_size": 4, "spatial_merge_size": 2,
                      "temporal_patch_size": 2, "hidden_size": 256},
}
VISION_YAML = {"name": "qwen2-vl-2b", "backend": "vlm", "model": "qwen2-vl-2b",
               "context_size": 4096, "max_slots": 8, "kv_pages": 256, "kv_page_size": 128,
               "prefill_chunk": 512, "template": {"family": "chatml"}}
LLAVA_YAML = {"name": "llava-8b", "backend": "llava", "model": "llama-3-8b",
              "options": {"vision": "clip-vit-l-336"}, "context_size": 2048, "max_slots": 4,
              "kv_pages": 64, "kv_page_size": 128, "template": {"family": "chatml"}}
VISION_NEW = 16  # tokens a chat
# The 8 concurrent chats: (image (h, w) or None, text length).
VISION_CHATS = [((448, 448), 40), (None, 200), ((336, 504), 60), (None, 700),
                ((448, 448), 90), (None, 60), ((672, 448), 30), (None, 400)]
ASCII_BIAS = {i: 100.0 for i in range(32, 127)}


def _png_bytes(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] as an 8-bit RGB PNG (filter 0 on every row)."""
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _vision_image(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth image with noise: gradients and a seeded pattern."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([x / w, y / h, (x + y) / (w + h)], axis=-1) * 160.0
    img = base + rng.random((h, w, 3)).astype(np.float32) * 95.0
    return img.clip(0, 255).astype(np.uint8)


def _vision_chat(model: str, img, text: str, stream: bool = False) -> dict:
    import base64

    parts = [{"type": "text", "text": text}]
    if img is not None:
        uri = "data:image/png;base64," + base64.b64encode(_png_bytes(img)).decode()
        parts.append({"type": "image_url", "image_url": {"url": uri}})
    return {"model": model, "messages": [{"role": "user", "content": parts}],
            "max_tokens": VISION_NEW, "temperature": 0.0, "ignore_eos": True,
            "logit_bias": {str(k): v for k, v in ASCII_BIAS.items()}, "stream": stream}


def _vision_post(base: str, body: dict, label: str) -> tuple[dict, float]:
    t = time.monotonic()
    st, _h, resp = _http_call(base, "POST", "/v1/chat/completions", body,
                              headers={"extra-usage": "1"}, timeout=900)
    check(st == 200, f"vision: {label} answered {st}: {str(resp)[:400]}")
    return resp, (time.monotonic() - t) * 1e3


def _vision_round(base: str, model: str, label: str) -> list[dict]:
    """VISION_CHATS, all at once → [(content, usage)] in order."""
    results: list = [None] * len(VISION_CHATS)

    def run(i, img_hw, n):
        img = None if img_hw is None else _vision_image(*img_hw, seed=40 + i)
        body = _vision_chat(model, img, _obs_text(n, 900 + i))
        results[i] = _http_call(base, "POST", "/v1/chat/completions", body, timeout=900)

    threads = [threading.Thread(target=run, args=(i, *c), daemon=True)
               for i, c in enumerate(VISION_CHATS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    out = []
    for i, res in enumerate(results):
        check(res is not None and res[0] == 200, f"vision: {label} chat {i}: {res and res[2]}")
        out.append({"content": res[2]["choices"][0]["message"]["content"],
                    "usage": res[2]["usage"]})
    return out


def _vision_qwen(base: str, manager) -> dict:
    from localai_tpu_torch.engine.engine import Engine, GenRequest
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.models import qwen2_vl as QV
    from localai_tpu_torch.ops import attention
    from localai_tpu_torch.ops.flash import flash_prefill_attention_plain
    from localai_tpu_torch.server.images import extract_images

    out: dict = {}
    t0 = time.monotonic()
    lm = manager.get("qwen2-vl-2b")
    eng, vis = lm.engine, lm.vision
    torch.cuda.synchronize()
    out["load_s"] = time.monotonic() - t0
    cfg = eng.cfg
    check(vis is not None and vis.kind == "qwen2_vl" and eng._mrope and eng._paged
          and vis.params["patch_embed.weight"].dtype == torch.bfloat16
          and (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_) == (28, 12, 2, 128),
          f"vision: Qwen2-VL-2B loaded as {cfg}")
    out["weight_bytes"] = eng.metrics()["weight_bytes"]
    out["tower_bytes"] = sum(t.numel() * t.element_size() for t in vis.params.values())

    # The tower at both images: preprocess (host), the tower (device), the
    # peak memory over the model's; then the bf16 tower against f32.
    towers = {}
    for key, hw, want_n in (("448", (448, 448), 256), ("max", (1120, 896), 1280)):
        img = _vision_image(*hw, seed=1)
        t = time.monotonic()
        patches, grid = QV.preprocess(vis.cfg, img)
        pre_ms = (time.monotonic() - t) * 1e3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        feats = vis.encode_patches(patches, grid)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        ms = cuda_time_ms(lambda: vis.encode_patches(patches, grid), 3, warmup=1)
        check(tuple(feats.shape) == (want_n, 1536) and bool(torch.isfinite(feats).all()),
              f"vision: tower at {hw} gave {tuple(feats.shape)}")
        towers[key] = {"image": list(hw), "grid": list(grid), "patches": int(patches.shape[0]),
                       "tokens": want_n, "preprocess_ms": pre_ms, "tower_ms": ms,
                       "peak_extra_gib": peak}
        if key == "448":
            dev = feats.device
            angles = torch.from_numpy(QV._vision_rope_angles(vis.cfg, grid)).to(dev)
            p32 = {k: v.float() for k, v in vis.params.items()}
            with torch.inference_mode():
                f32 = QV.vision_forward(vis.cfg, p32, torch.from_numpy(patches).to(dev), angles)
            cos = torch.nn.functional.cosine_similarity(feats.float(), f32, dim=-1)
            towers[key]["f32_cosine_min"] = float(cos.min())
            towers[key]["f32_cosine_mean"] = float(cos.mean())
            check(float(cos.min()) >= 0.99,
                  f"vision: the bf16 tower's merged tokens against f32: cosine {float(cos.min())}")
            del p32, f32
    out["tower"] = towers
    log(f"[vision qwen2-vl-2b tower] {json.dumps(towers)}")

    # Prefill with the largest image injected and m-rope through B1, against
    # the same call with B1's plain version swapped in.
    img = _vision_image(1120, 896, seed=2)
    feats, grid = vis.encode_with_grid(img)
    n_img = feats.shape[0]
    ids = [1] + [0] * n_img + list(range(40, 72))
    pos3, delta = QV.mrope_positions_for_span(len(ids), 1, grid)
    S = eng._bucket_for(len(ids))
    toks = torch.zeros((1, S), dtype=torch.int64, device="cuda")
    toks[0, :len(ids)] = torch.tensor(ids)
    mr = np.zeros((1, 3, S), np.int64)
    mr[0, :, :len(ids)] = pos3
    mr[0, :, len(ids):] = pos3[:, -1:] + 1 + np.arange(S - len(ids))
    args = (cfg, eng.params, toks, torch.tensor([len(ids)], device="cuda"))
    kw = dict(inject=(feats[None], torch.tensor([1], device="cuda")),
              mrope=torch.from_numpy(mr).cuda())
    before = _read_counts()["flash_prefill"]
    with torch.inference_mode():
        logits, _, _ = llama.prefill(*args, **kw)
        b1 = _read_counts()["flash_prefill"] - before
        with swapped(attention, "flash_prefill_attention", flash_prefill_attention_plain):
            ref, _, _ = llama.prefill(*args, **kw)
    err, scale = float((logits - ref).abs().max()), float(ref.abs().max())
    out["prefill_b1_vs_plain"] = {"bucket": S, "prompt": len(ids), "image_tokens": n_img,
                                  "rope_delta": delta, "max_abs_err": err, "max_logit": scale,
                                  "b1_launches": b1}
    check(b1 == cfg.num_layers and err <= 0.05 * scale and bool(torch.isfinite(logits).all()),
          f"vision: prefill with inject + m-rope through B1 against its plain version: "
          f"{out['prefill_b1_vs_plain']}")

    # 8 concurrent chats, images and text, over HTTP with graph decode
    # blocks, first on the fresh engine: its block shapes are captured while
    # other requests' towers run on their threads. Every response 200,
    # usage counting each image's span.
    runs = {}
    _zero_counts()
    blocks0, tok0, dt0 = eng.m_blocks, eng._decode_tokens, eng._decode_time
    caps0, reps0 = eng.m_graph_captures, eng.m_graph_replays
    t = time.monotonic()
    served = _vision_round(base, "qwen2-vl-2b", "graph")
    wall = time.monotonic() - t
    lg = _read_counts()
    runs["vision_qwen2_vl_2b"] = {"launches": lg}
    blocks = eng.m_blocks - blocks0
    caps, reps = eng.m_graph_captures - caps0, eng.m_graph_replays - reps0
    check(blocks == caps + reps and blocks > 0,
          f"vision: {blocks} decode blocks, {caps} captures + {reps} replays")
    for i, ((hw, n), g) in enumerate(zip(VISION_CHATS, served)):
        check(g["usage"]["completion_tokens"] == VISION_NEW,
              f"vision: chat {i} usage {g['usage']}")
        if hw is not None:
            rh, rw = QV.smart_resize(*hw)
            want = rh * rw // (28 * 28)
            check(g["usage"]["prompt_tokens"] >= want + n,
                  f"vision: chat {i} prompt_tokens {g['usage']['prompt_tokens']} < {want} + {n}")
    check(lg["flash_prefill"] > 0 and lg["paged_attention"] > 0
          and lg["flash_prefill"] % cfg.num_layers == 0
          and lg["paged_attention"] % cfg.num_layers == 0,
          f"vision: launches {lg}")
    out["round"] = {"wall_s": wall, "blocks": blocks, "captures": caps, "replays": reps,
                    "launches": lg, "tokens": VISION_NEW * len(VISION_CHATS),
                    "decode_tok_s": ((eng._decode_tokens - tok0)
                                     / max(eng._decode_time - dt0, 1e-9))}
    log(f"[vision qwen2-vl-2b round] {json.dumps(out['round'])}")
    # One image chat, then the same chat again: its TTFT streamed and its
    # split (PNG decode, preprocess, tower, the engine's queue wait and
    # admission); another image.
    img448, other = _vision_image(448, 448, seed=3), _vision_image(448, 448, seed=4)
    body = _vision_chat("qwen2-vl-2b", img448, "describe the picture")
    first, first_ms = _vision_post(base, body, "the image chat")
    again, wall = _vision_post(base, body, "the same image again")
    stream = _http(base, "/v1/chat/completions", dict(body, stream=True), time.monotonic())
    t = time.monotonic()
    extract_images(body["messages"])
    decode_ms = (time.monotonic() - t) * 1e3
    t = time.monotonic()
    patches, grid = QV.preprocess(vis.cfg, img448)
    pre_ms = (time.monotonic() - t) * 1e3
    diff, _ = _vision_post(base, _vision_chat("qwen2-vl-2b", other, "describe the picture"),
                           "another image")
    text_only, _ = _vision_post(base, _vision_chat("qwen2-vl-2b", None, "describe the picture"),
                                "the text alone")
    u, ut = again["usage"], text_only["usage"]
    span = u["prompt_tokens"] - ut["prompt_tokens"]
    c0, c1, c2 = (r["choices"][0]["message"]["content"] for r in (first, again, diff))
    try:
        import PIL  # noqa: F401

        decoder = "PIL"
    except ImportError:
        decoder = "server/images.decode_png"
    out["chat"] = {
        "first_wall_ms": first_ms, "wall_ms": wall,
        "ttft_ms_stream": (stream.get("ttft") or 0.0) * 1e3,
        "png_decoder": decoder, "png_decode_ms": decode_ms, "preprocess_ms": pre_ms,
        "tower_ms": towers["448"]["tower_ms"],
        "queue_wait_ms": u.get("timing_queue_wait", 0.0) * 1e3,
        "admission_to_first_token_ms": u.get("timing_prompt_processing", 0.0) * 1e3,
        "decode_ms": u.get("timing_token_generation", 0.0) * 1e3,
        "image_span": span, "same_image_same_ids": c0 == c1, "other_image_other_ids": c0 != c2,
        "content": c0}
    log(f"[vision qwen2-vl-2b chat] {json.dumps(out['chat'])}")
    check(stream["status"] == 200 and span == 256 and len(c0) == VISION_NEW,
          f"vision: the image chat: span {span}, content {c0!r}")
    check(c0 == c1, "vision: the same image gave other ids")
    check(c0 != c2, "vision: another image gave the same ids")

    out["graph_vs_eager"] = _vision_graph_vs_eager(eng, vis, runs)

    # A text request with three equal m-rope streams against the same
    # request on the same weights with no m-rope section, each on a fresh
    # engine of the served config: the same ids (three equal streams are
    # plain rope, and the rope delta is 0).
    prompt = list(range(60, 124))
    req = GenRequest(prompt_ids=prompt, max_new_tokens=VISION_NEW, temperature=0.0,
                     ignore_eos=True, logit_bias=ASCII_BIAS)
    streams = np.tile(np.arange(len(prompt), dtype=np.int32), (3, 1))
    texts = []
    for c, r in ((cfg, dataclasses.replace(req, mrope_positions=streams)),
                 (dataclasses.replace(cfg, mrope_section=()), req)):
        e = Engine(c, eng.params, eng.tokenizer, engine_cfg=eng.ecfg, device="cuda")
        try:
            texts.append(e.submit(r).result()[0])
        finally:
            e.stop()
            del e
    out["text_equals_plain_rope"] = texts[0] == texts[1]
    check(texts[0] == texts[1], f"vision: three equal m-rope streams {texts[0]!r} != plain "
                                f"rope {texts[1]!r}")
    return {"summary": out, "runs": runs}


def _vision_requests(eng, vis) -> list:
    """VISION_CHATS as GenRequests on the served engine's template: the
    images' features (the tower on the card), placeholder spans after
    BOS, m-rope streams."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.models import qwen2_vl as QV

    reqs = []
    for i, (hw, n) in enumerate(VISION_CHATS):
        ids = [eng.tokenizer.bos_id] + eng.tokenizer.encode(
            f"<|im_start|>user\n{_obs_text(n, 900 + i)}<|im_end|>\n<|im_start|>assistant\n")
        kw = {}
        if hw is not None:
            feats, grid = vis.encode_with_grid(_vision_image(*hw, seed=40 + i))
            ids = ids[:1] + [0] * feats.shape[0] + ids[1:]
            pos3, _ = QV.mrope_positions_for_span(len(ids), 1, grid)
            kw = dict(image_embeds=feats, image_offset=1, mrope_positions=pos3)
        reqs.append(GenRequest(prompt_ids=ids, max_new_tokens=VISION_NEW, temperature=0.0,
                               ignore_eos=True, logit_bias=ASCII_BIAS, **kw))
    return reqs


def _vision_graph_vs_eager(served, vis, runs: dict) -> dict:
    """VISION_CHATS (built once) on two fresh engines over the served
    weights, on the served engine's pool config: one replaying its decode
    graphs, one running the eager block body. The requests are all queued
    before the loop starts, so both see the same admissions and blocks;
    ids and launches must be identical (blocks mixing image and text slots,
    each at its own rope delta)."""
    from localai_tpu_torch.engine.engine import Engine

    reqs = _vision_requests(served, vis)
    ids, launches, stats = {}, {}, {}
    for mode in ("graph", "eager"):
        eng = Engine(served.cfg, served.params, served.tokenizer, device="cuda",
                     engine_cfg=dataclasses.replace(served.ecfg, block_sizes=(16, 4, 1)))
        try:
            with contextlib.ExitStack() as stack:
                if mode == "eager":
                    stack.enter_context(swapped(eng, "_decode_block", eng._block_body))
                with swapped(eng, "start", lambda: None):  # queue all before the loop runs
                    handles = [eng.submit(dataclasses.replace(r)) for r in reqs]
                _zero_counts()
                t = time.monotonic()
                eng.start()
                ids[mode] = [[e.token_id for e in h if e.kind == "token"] for h in handles]
                stats[mode] = {"wall_s": time.monotonic() - t, "blocks": eng.m_blocks,
                               "captures": eng.m_graph_captures,
                               "replays": eng.m_graph_replays}
                launches[mode] = _read_counts()
        finally:
            eng.stop()
            del eng
    runs["vision_qwen2_vl_2b_graph"] = {"launches": launches["graph"]}
    runs["vision_qwen2_vl_2b_eager"] = {"launches": launches["eager"]}
    out = {"ids_equal": ids["graph"] == ids["eager"],
           "launches_equal": launches["graph"] == launches["eager"],
           "launches": launches["graph"], **{f"{k}_{m}": v for m in stats
                                              for k, v in stats[m].items()}}
    log(f"[vision qwen2-vl-2b graph vs eager] {json.dumps(out)}")
    check(all(len(x) == VISION_NEW for x in ids["graph"]), "vision: a request ended early")
    check(out["ids_equal"], f"vision: graph ids differ from the eager body's: "
                            f"{ids['graph']} / {ids['eager']}")
    check(out["launches_equal"] and stats["eager"]["replays"] == 0
          and stats["graph"]["blocks"] == stats["graph"]["captures"] + stats["graph"]["replays"],
          f"vision: graph / eager launches {launches} or blocks {stats}")
    return out


def _vision_llava(base: str, manager) -> dict:
    out: dict = {}
    t0 = time.monotonic()
    lm = manager.get("llava-8b")
    eng, vis = lm.engine, lm.vision
    torch.cuda.synchronize()
    out["load_s"] = time.monotonic() - t0
    check(vis is not None and vis.kind == "llava" and vis.cfg.layers == 24
          and vis.cfg.n_patches == 576 and eng.cfg.num_layers == 32,
          f"vision: llava loaded as {vis and vis.cfg}")
    img = _vision_image(336, 336, seed=5)
    pix = vis.preprocess(img).cuda()
    from localai_tpu_torch.models.vision import encode_image

    with torch.inference_mode():
        out["tower_ms"] = cuda_time_ms(lambda: encode_image(vis.cfg, vis.params, pix), 3, warmup=1)
    _zero_counts()
    first, wall = _vision_post(base, _vision_chat("llava-8b", img, "describe"), "llava image")
    again, _ = _vision_post(base, _vision_chat("llava-8b", img, "describe"), "llava again")
    diff, _ = _vision_post(base, _vision_chat("llava-8b", _vision_image(500, 400, seed=6),
                                              "describe"), "llava another image")
    text, _ = _vision_post(base, _vision_chat("llava-8b", None, "describe"), "llava text")
    launches = _read_counts()
    c0, c1, c2 = (r["choices"][0]["message"]["content"] for r in (first, again, diff))
    span = first["usage"]["prompt_tokens"] - text["usage"]["prompt_tokens"]
    out.update(wall_ms=wall, image_span=span, same_image_same_ids=c0 == c1,
               other_image_other_ids=c0 != c2, launches=launches,
               admission_to_first_token_ms=first["usage"].get("timing_prompt_processing", 0) * 1e3,
               content=c0)
    log(f"[vision llava-8b] {json.dumps(out)}")
    check(span == 576 and len(c0) == VISION_NEW, f"vision: llava span {span}, content {c0!r}")
    check(c0 == c1 and c0 != c2, "vision: llava ids: the same image must repeat them, another "
                                 "must change them")
    check(launches["flash_prefill"] == 4 * 32 and launches["paged_attention"] > 0,
          f"vision: llava launches {launches}")
    return {"summary": out, "runs": {"vision_llava_8b": {"launches": launches}}}


def _vision_tiny(root: str) -> dict:
    """The CPU tests' tiny f32 Qwen2-VL on the card and on the CPU: prefill
    logits with inject + m-rope within 1e-4, greedy ids of an image and a
    text request exact."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine.weights import arch_from_hf_config, load_hf_checkpoint
    from localai_tpu_torch.models import llama
    from localai_tpu_torch.models import qwen2_vl as QV

    d = f"{root}/tiny-qwen2vl"
    QV.random_hf_checkpoint(d, QWEN2_VL_TINY, seed=0, scale=0.1, device="cpu")
    arch = dataclasses.replace(arch_from_hf_config(d), dtype="float32")
    vc = dataclasses.replace(QV.vision_config_from_hf(d), min_pixels=8 * 8, max_pixels=1 << 28)
    out, ids, logits = {}, {}, {}
    img = _vision_image(48, 32, seed=7)
    for dev in ("cuda", "cpu"):
        params = load_hf_checkpoint(arch, d, device=dev)
        enc = QV.Qwen2VLVisionEncoder(vc, QV.load_hf_qwen2_vl_vision(vc, d, device=dev))
        feats, grid = enc.encode_with_grid(img)
        prompt = [5, 7, 297] + [0] * feats.shape[0] + [298, 11, 12, 13]
        pos3, _ = QV.mrope_positions_for_span(len(prompt), 3, grid)
        toks = torch.zeros((1, 64), dtype=torch.int64)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        mr = np.zeros((1, 3, 64), np.int64)
        mr[0, :, :len(prompt)] = pos3
        with torch.inference_mode():
            lg, _, _ = llama.prefill(arch, params, toks.to(dev), torch.tensor([len(prompt)],
                                                                               device=dev),
                                     inject=(feats[None], torch.tensor([3], device=dev)),
                                     mrope=torch.from_numpy(mr).to(dev))
        logits[dev] = lg.cpu()
        eng = Engine(arch, params, ByteTokenizer(300), device=dev,
                     engine_cfg=EngineConfig(max_slots=2, max_seq=128, min_prefill_bucket=16,
                                             kv_pages=16, kv_page_size=16))
        try:
            hs = [eng.submit(GenRequest(prompt_ids=prompt, image_embeds=feats, image_offset=3,
                                        mrope_positions=pos3, max_new_tokens=12,
                                        ignore_eos=True)),
                  eng.submit(GenRequest(prompt_ids=list(range(5, 35)), max_new_tokens=12,
                                        ignore_eos=True))]
            ids[dev] = [[e.token_id for e in h if e.kind == "token"] for h in hs]
        finally:
            eng.stop()
    out["logits_max_abs_err"] = float((logits["cuda"] - logits["cpu"]).abs().max())
    out["ids_equal"] = ids["cuda"] == ids["cpu"]
    log(f"[vision tiny qwen2-vl card vs cpu] {json.dumps(out)}")
    check(out["logits_max_abs_err"] <= 1e-4 and out["ids_equal"],
          f"vision: tiny Qwen2-VL card vs CPU: {out}, ids {ids}")
    return out


def phase_vision() -> dict:
    """Vision chat through ModelManager and the port's HTTP server: (a)
    Qwen2-VL-2B, (b) llava (clip-vit-l-336 into llama-3-8b), (c) the tiny
    Qwen2-VL card vs CPU."""
    import yaml

    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.models import qwen2_vl as QV
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server

    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        QV.random_hf_checkpoint(f"{root}/qwen2-vl-2b", QWEN2_VL_2B, seed=3,
                                dtype=torch.bfloat16, device="cuda")
        seconds["write_checkpoint"] = round(time.monotonic() - t0, 1)
        for doc in (VISION_YAML, LLAVA_YAML):
            with open(f"{root}/{doc['name']}.yaml", "w") as f:
                yaml.safe_dump(doc, f)
        app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=root)
        manager = ModelManager(app, device="cuda")
        router = Router()
        OpenAIApi(manager).register(router)
        server = create_server(app, router)
        threading.Thread(target=server.serve_forever, daemon=True, name="http").start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def part(name, fn, *args):
            t = time.monotonic()
            out[name] = fn(*args)
            seconds[name] = round(time.monotonic() - t, 1)

        try:
            part("qwen2_vl", _vision_qwen, base, manager)
            manager.unload("qwen2-vl-2b", drain_s=0.0)
            gc.collect()
            torch.cuda.empty_cache()
            part("llava", _vision_llava, base, manager)
            manager.unload("llava-8b", drain_s=0.0)
            part("tiny", _vision_tiny, root)
            out["seconds"] = seconds
        finally:
            server.shutdown()
            manager.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    out["runs"] = {**out["qwen2_vl"].pop("runs"), **out["llava"].pop("runs")}
    log(json.dumps({"vision": {k: v for k, v in out.items() if k != "runs"}}))
    return out


# --------------------------------------------------------------------------- #
# 26. service: out-of-process backends and the service surfaces
# --------------------------------------------------------------------------- #

# The served 1b of the earlier phases (the paged pool, chunks of 512) at
# SERVICE_LAYERS of its 16 layers, read from a checkpoint written once to
# disk, so the parent and its child load the same bf16 bytes. No tokenizer key: the
# checkpoint holds no tokenizer files, so both take the byte tokenizer,
# and requests carry ASCII_BIAS, so a reply's text is its ids.
SERVICE_YAML = dict({k: v for k, v in LORA_BASE_YAML.items()
                     if k not in ("name", "model", "tokenizer")}, embeddings=True)
SERVICE_NEW = 16  # tokens a chat (one 16-step block)
# 8, not ONEB_LAYERS: the phase holds the child's greedy ids equal to the
# in-process engine's, whose admissions batch differently; at 4 layers the
# random 1b's top two ASCII-biased logits sit within that rounding (its
# first token parted on the card).
SERVICE_LAYERS = 8
SERVICE_KILL_NEW = 512  # tokens the stream killed mid-decode asks for
SERVICE_REPS = 3  # warm chats through the relay and straight to the child, alternated
SERVICE_TEXT = "the service phase asks every backend the same question " * 4
# The card memory a live child must hold (its 1.5 GB of weights alone),
# and how much of its memory may be missing after its death.
SERVICE_CHILD_MIN_BYTES = 1 << 30
SERVICE_RETURN_TOL_BYTES = 256 << 20


class _StubMcp:
    """An MCP server on loopback (JSON-RPC over HTTP) with one `add` tool;
    counts the methods it was asked."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.methods: list[str] = []
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                req = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
                outer.methods.append(req.get("method"))
                result = {"tools": [{"name": "add", "description": "Add two integers",
                                     "inputSchema": {"type": "object"}}]} \
                    if req.get("method") == "tools/list" else {}
                body = json.dumps({"jsonrpc": "2.0", "id": req.get("id"),
                                   "result": result}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/mcp"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()


def _serve_dir(path: str):
    """A stdlib HTTP server over `path` on loopback (the local gallery)."""
    import functools
    from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

    class Quiet(SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Quiet, directory=path))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _service_body(model: str, n: int = SERVICE_NEW, stream: bool = False) -> dict:
    return {"model": model, "messages": [{"role": "user", "content": SERVICE_TEXT}],
            "max_tokens": n, "temperature": 0.0, "ignore_eos": True, "stream": stream,
            "logit_bias": {str(k): v for k, v in ASCII_BIAS.items()}}


def _service_chat(base: str, model: str, label: str) -> tuple[str, float]:
    """One greedy chat: (its text = its ids, wall ms)."""
    t = time.monotonic()
    st, _h, r = _http_call(base, "POST", "/v1/chat/completions", _service_body(model),
                           timeout=900)
    ms = (time.monotonic() - t) * 1e3
    check(st == 200, f"service: {label} answered {st}: {str(r)[:400]}")
    text = r["choices"][0]["message"]["content"]
    check(len(text) == SERVICE_NEW and all(32 <= ord(c) < 127 for c in text),
          f"service: {label}: {len(text)} characters, not {SERVICE_NEW} printable ids")
    return text, ms


def _service_stream(base: str, model: str, label: str) -> tuple[str, float]:
    """One greedy streamed chat: (its text, TTFT ms)."""
    res = _http(base, "/v1/chat/completions", _service_body(model, stream=True),
                time.monotonic())
    check(res["status"] == 200 and res["frames"][-1] == "[DONE]",
          f"service: {label} stream answered {res['status']}")
    chunks = [json.loads(f) for f in res["frames"][:-1]]
    check(not any("error" in c for c in chunks), f"service: {label} stream errored")
    text = "".join((c["choices"][0].get("delta") or {}).get("content") or "" for c in chunks)
    return text, res["ttft"] * 1e3


def _free_card_bytes() -> int:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return int(torch.cuda.mem_get_info()[0])


def _service_parting_probe(lm) -> dict:
    """The service chat's first greedy choice on the 1b at ONEB_LAYERS (init
    seed 0, as the phase's checkpoint): at that depth a subprocess child's
    first token once parted from the in-process engine's (ROADMAP Queue
    C), so the phase serves SERVICE_LAYERS. The prompt ids are the chat's
    (the served model's template and tokenizer); the logits a plain bf16
    prefill's and its f32 witness's, each with the chat's ASCII bias: the
    top two tokens and their gap, beside PREFIX_LOGIT_TOL of the largest
    unbiased |logit| (the near-tie bound, without the bias's 100 in it)."""
    from localai_tpu_torch.models import get_arch, llama

    cfg = dataclasses.replace(get_arch(ONEB_PRESET), num_layers=ONEB_LAYERS)
    prompt = lm.evaluator.template_messages(_service_body("probe")["messages"])
    ids = lm.engine.tokenizer.encode(prompt, add_bos=not lm.cfg.template.use_tokenizer_template)
    params = llama.init_params(cfg, seed=0, device="cuda")
    out = {"layers": ONEB_LAYERS, "prompt_tokens": len(ids)}
    for label, c, p in (("bf16", cfg, params),
                        ("f32", dataclasses.replace(cfg, dtype="float32"), _f32_tree(params))):
        with torch.no_grad():
            logits = llama.prefill(c, p, torch.tensor([ids], device="cuda"),
                                   torch.tensor([len(ids)], device="cuda"))[0][0].float()
        bound = PREFIX_LOGIT_TOL * float(logits.abs().max())
        for t, b in ASCII_BIAS.items():
            logits[t] += b
        top = torch.topk(logits, 2)
        out[label] = dict(top2=[lm.engine.tokenizer.decode([int(t)]) for t in top.indices],
                          gap=float(top.values[0] - top.values[1]), bound=bound)
        del p
    del params
    torch.cuda.empty_cache()
    log(f"[service parting probe] {json.dumps(out)}")
    return out


def phase_service() -> dict:
    """Out-of-process backends and the service surfaces through the CLI's
    app (`__main__.build_app`: every layer the port registers) on the card:
    the 4-layer 1b written once to a checkpoint, imported through
    /models/import-uri (file://) and served in this process; a `subprocess`
    model whose child serves the same checkpoint on the card (spawn to
    ready, the first chat through the parent, warm chats through the relay
    against the same chats straight to the child: the relay's cost in ms,
    wall and streamed TTFT; the child's ids equal to the relay's and to the
    in-process model's; a stream, /v1/embeddings and /v1/tokenize relayed);
    SIGKILL of the child mid-stream (an error frame ends that stream, the
    in-process model still answers, the next request respawns the child
    with the same ids, the dead child's card memory comes back, no kernel
    library rebuilt); a `remote` model on this server's own port and one on
    a dead port (502, the server survives); a gallery install over local
    HTTP served on the card; one /mcp/v1/chat/completions against a stub
    MCP server through the 1b engine."""
    import signal
    import urllib.request

    import yaml

    from localai_tpu_torch.__main__ import build_app
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.engine.remote import SubprocessEngine
    from localai_tpu_torch.engine.weights import save_hf_checkpoint
    from localai_tpu_torch.kernels import BUILD_DIR
    from localai_tpu_torch.models import get_arch, llama
    from localai_tpu_torch.server import create_server

    seconds = {}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.monotonic()
        models, ckpt, gdir = f"{root}/models", f"{root}/llama-1b", f"{root}/gallery"
        os.makedirs(models)
        cfg = dataclasses.replace(get_arch(ONEB_PRESET), num_layers=SERVICE_LAYERS)
        params = llama.init_params(cfg, seed=0, device="cuda")
        save_hf_checkpoint(cfg, params, ckpt)
        del params
        # The gallery's model: tiny-d64's widths (head dim 64, which B1 takes).
        tiny = dataclasses.replace(get_arch("tiny"), hidden_size=256, intermediate_size=512,
                                   num_heads=4, num_kv_heads=2, dtype="float32")
        save_hf_checkpoint(tiny, llama.init_params(tiny, seed=5, device="cuda"), f"{gdir}/tiny")
        torch.cuda.empty_cache()
        seconds["write_checkpoints"] = round(time.monotonic() - t0, 1)
        gallery_srv, gurl = _serve_dir(gdir)
        files = [{"filename": f, "uri": f"{gurl}/tiny/{f}",
                  "sha256": hashlib.sha256(open(f"{gdir}/tiny/{f}", "rb").read()).hexdigest()}
                 for f in sorted(os.listdir(f"{gdir}/tiny"))]
        with open(f"{gdir}/index.yaml", "w") as f:
            yaml.safe_dump([{"name": "tiny-gallery", "description": "tiny-d64", "files": files,
                             "overrides": {"context_size": 256, "max_slots": 2,
                                           "max_tokens": 8}}], f)
        mcp = _StubMcp()
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_port = dead.getsockname()[1]
        dead.close()  # nothing listens there
        child = dict(SERVICE_YAML, name="child-1b", model=ckpt)
        for name, doc in (("child-1b", {"model": "subprocess", "backend": "subprocess",
                                        "embeddings": True, "options": {"child": child}}),
                          ("dead-remote", {"model": "remote", "backend": "remote",
                                           "options": {"url": f"http://127.0.0.1:{dead_port}"}})):
            with open(f"{models}/{name}.yaml", "w") as f:
                yaml.safe_dump({"name": name, **doc}, f)
        app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=models,
                                galleries=[{"name": "local", "url": f"{gurl}/index.yaml"}],
                                runtime_settings_path=f"{models}/runtime_settings.json")
        manager, router, jobs = build_app(app, device="cuda")
        jobs.start()
        server = create_server(app, router)
        threading.Thread(target=server.serve_forever, daemon=True, name="http").start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        eng = None
        try:
            # (a) the in-process model, through /models/import-uri.
            t0 = time.monotonic()
            st, _h, r = _http_call(base, "POST", "/models/import-uri", {
                "uri": f"file://{ckpt}", "name": "local-1b",
                "preferences": dict(SERVICE_YAML, options={
                    "mcp": {"remote": [{"name": "stub", "url": mcp.url}]}})})
            check(st == 201 and r["status"] == "installed", f"service: import-uri {st}: {r}")
            with open(f"{models}/self-remote.yaml", "w") as f:
                yaml.safe_dump({"name": "self-remote", "model": "remote", "backend": "remote",
                                "options": {"url": base, "remote_model": "local-1b"}}, f)
            st, _h, r = _http_call(base, "POST", "/models/reload", {})
            check(st == 200 and "self-remote" in r["models"], f"service: reload {st}: {r}")
            _zero_counts()
            local_text, local_first_ms = _service_chat(base, "local-1b", "local-1b (first)")
            seconds["local_first_chat"] = round(time.monotonic() - t0, 1)

            # (b) the subprocess model.
            free_before = _free_card_bytes()
            builds = {p.name: p.stat().st_mtime_ns for p in BUILD_DIR.glob("*.so")}
            eng = manager.get("child-1b").engine
            check(isinstance(eng, SubprocessEngine) and eng.pid is None,
                  "service: child-1b is not an unspawned subprocess engine")
            t0 = time.monotonic()
            first_text, first_ms = _service_chat(base, "child-1b", "child-1b (first)")
            seconds["child_first_chat"] = round(time.monotonic() - t0, 1)
            spawn_s = eng.m_spawn_s
            free_with = _free_card_bytes()
            direct = eng.base_url
            walls, ttfts = {"relay": [], "direct": []}, {"relay": [], "direct": []}
            for _ in range(SERVICE_REPS):
                for via, b, model in (("relay", base, "child-1b"), ("direct", direct, "child-1b")):
                    text, ms = _service_chat(b, model, f"child-1b {via}")
                    check(text == first_text, f"service: child-1b {via} ids {text!r} != "
                                              f"{first_text!r}")
                    walls[via].append(ms)
                    text, ttft = _service_stream(b, model, f"child-1b {via}")
                    check(text == first_text, f"service: child-1b {via} streamed ids differ")
                    ttfts[via].append(ttft)
            check(first_text == local_text, f"service: the child's ids {first_text!r} differ "
                                            f"from the in-process model's {local_text!r}")
            relayed = {}
            for path, body in (("/v1/embeddings", {"input": [SERVICE_TEXT, [72, 105, 33]]}),
                               ("/v1/tokenize", {"content": SERVICE_TEXT})):
                st, _h, via = _http_call(base, "POST", path, {"model": "child-1b", **body})
                st2, _h, dr = _http_call(direct, "POST", path, {"model": "child-1b", **body})
                check(st == st2 == 200 and via == dr, f"service: {path} relayed {st}, direct "
                                                      f"{st2}, bodies equal {via == dr}")
                relayed[path] = True
            emb = _http_call(base, "POST", "/v1/embeddings",
                             {"model": "child-1b", "input": SERVICE_TEXT})[2]
            vec = np.asarray(emb["data"][0]["embedding"])
            check(np.isfinite(vec).all() and abs(np.linalg.norm(vec) - 1) < 1e-3,
                  "service: the relayed embedding is not a finite unit vector")

            # (c) SIGKILL mid-stream.
            req = urllib.request.Request(
                base + "/v1/chat/completions",
                data=json.dumps(_service_body("child-1b", SERVICE_KILL_NEW, True)).encode(),
                headers={"Content-Type": "application/json"})
            frames, killed_at = [], None
            pid = eng.pid
            with urllib.request.urlopen(req, timeout=300) as r:
                for line in r:
                    line = line.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    frames.append(line[6:])
                    if killed_at is None and len(frames) >= 5:
                        os.kill(pid, signal.SIGKILL)
                        killed_at = len(frames)
            err = [json.loads(f)["error"] for f in frames[:-1] if "error" in json.loads(f)]
            check(frames[-1] == "[DONE]" and len(err) == 1 and err[0].get("code") == 502
                  and len(frames) - 2 < SERVICE_KILL_NEW,
                  f"service: the killed stream did not end with an error frame "
                  f"({len(frames)} frames, errors {err})")
            eng._proc.wait(timeout=60)
            # The driver frees a dead process's memory as it reaps it.
            for _ in range(100):
                free_after = _free_card_bytes()
                if free_after >= free_before - SERVICE_RETURN_TOL_BYTES:
                    break
                time.sleep(0.1)
            again, _ms = _service_chat(base, "local-1b", "local-1b after the kill")
            check(again == local_text, "service: the in-process model's ids changed")
            t0 = time.monotonic()
            respawned, _ms = _service_chat(base, "child-1b", "child-1b (respawned)")
            seconds["respawn_chat"] = round(time.monotonic() - t0, 1)
            check(eng.m_respawns == 1 and eng.pid not in (None, pid),
                  f"service: respawns {eng.m_respawns}, pid {eng.pid} (was {pid})")
            check(respawned == first_text, "service: the respawned child's ids differ")
            check(free_before - free_with >= SERVICE_CHILD_MIN_BYTES,
                  f"service: the live child held only {free_before - free_with} bytes")
            check(free_after >= free_before - SERVICE_RETURN_TOL_BYTES,
                  f"service: {free_before - free_after} bytes of the dead child's memory "
                  f"did not come back")
            check({p.name: p.stat().st_mtime_ns for p in BUILD_DIR.glob("*.so")} == builds,
                  "service: the child rebuilt a kernel library")

            # (d) remotes: this server's own port, and a dead one.
            text, _ms = _service_chat(base, "self-remote", "self-remote")
            check(text == local_text, "service: self-remote ids differ from local-1b's")
            st, _h, r = _http_call(base, "POST", "/v1/chat/completions",
                                   _service_body("dead-remote"))
            check(st == 502, f"service: the dead remote answered {st}: {r}")
            check(_service_chat(base, "local-1b", "local-1b after the 502")[0] == local_text,
                  "service: the server did not survive the dead remote")

            # (e) a gallery install over local HTTP, served on the card; MCP.
            t0 = time.monotonic()
            st, _h, r = _http_call(base, "POST", "/models/apply", {"id": "local@tiny-gallery"})
            check(st == 200, f"service: /models/apply {st}: {r}")
            job = {}
            for _ in range(600):
                job = _http_call(base, "GET", r["status"])[2]
                if job.get("processed"):
                    break
                time.sleep(0.05)
            check(job.get("status") == "done", f"service: the gallery job ended {job}")
            st, _h, g = _http_call(base, "POST", "/v1/chat/completions", {
                "model": "tiny-gallery", "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 8, "ignore_eos": True, "temperature": 0.0})
            check(st == 200 and g["usage"]["completion_tokens"] == 8,
                  f"service: the installed gallery model answered {st}: {g}")
            check(manager.peek("tiny-gallery").engine.device.type == "cuda",
                  "service: the gallery model is not on the card")
            seconds["gallery"] = round(time.monotonic() - t0, 1)
            st, _h, m = _http_call(base, "POST", "/mcp/v1/chat/completions",
                                   {**_service_body("local-1b"), "stream": False})
            check(st == 200 and m["agent"]["iterations"] >= 1
                  and "tools/list" in mcp.methods,
                  f"service: MCP chat {st}: {str(m)[:300]}, stub saw {mcp.methods}")
            launches = _read_counts()
            check(launches["flash_prefill"] > 0 and launches["paged_attention"] > 0,
                  f"service: the in-process models did not launch B1 / B2: {launches}")
            probe = _service_parting_probe(manager.get("local-1b"))
        except SystemExit:
            log_path = f"{models}/.subprocess-child-1b/child.log"
            if os.path.exists(log_path):  # the child's own account of a failure
                print(open(log_path).read()[-4000:], file=sys.stderr, flush=True)
            raise
        finally:
            server.shutdown()
            jobs.stop()
            manager.shutdown()
            gallery_srv.shutdown()
            mcp.server.shutdown()
        check(eng._proc is None, "service: the manager's shutdown left the child running")
        gc.collect()
        torch.cuda.empty_cache()
    med = statistics.median
    out = dict(
        spawn_to_ready_s=spawn_s, respawn_to_ready_s=eng.m_spawn_s,
        child_first_chat_ms=first_ms, local_first_chat_ms=local_first_ms,
        relay_wall_ms=walls["relay"], direct_wall_ms=walls["direct"],
        relay_cost_ms=med(walls["relay"]) - med(walls["direct"]),
        relay_ttft_ms=ttfts["relay"], direct_ttft_ms=ttfts["direct"],
        relay_ttft_cost_ms=med(ttfts["relay"]) - med(ttfts["direct"]),
        relayed=relayed, killed_after_frames=killed_at, killed_stream_frames=len(frames),
        card_free_gib={"before_spawn": free_before / 2**30, "child_up": free_with / 2**30,
                       "after_kill": free_after / 2**30},
        child_card_gib=(free_before - free_with) / 2**30,
        returned_gib=(free_after - free_with) / 2**30,
        mcp_methods=sorted(set(mcp.methods)), seconds=seconds, launches=launches,
        parting_probe=probe)
    log(f"[service] {json.dumps(out)}")
    return {"summary": out, "run": {"launches": launches}}


# --------------------------------------------------------------------------- #
# 34. gguf_deepseek: a deepseek2 GGUF through B3's gq expert form, B2's latent
#     form and B4; 35. expert_lora: LoRA merged into mixtral's experts
# --------------------------------------------------------------------------- #

# deepseek-v2-lite at full width, 4 of its 27 layers: the dense layer and 3 MoE
# layers (cut for the run's time: the file's write and parse are host-bound).
GGUF_DEEPSEEK_LAYERS = 4
GGUF_DEEPSEEK_PROMPTS = [20, 100, 300, 700, 1500, 20, 100, 300]
GGUF_DEEPSEEK_NEW = 32  # tokens a request of the Engine.submit run
GGUF_DEEPSEEK_HTTP_NEW = 16  # tokens a chat of the HTTP run


def _check_gguf_deepseek_launches(label: str, cfg, out: dict, n: dict) -> None:
    """The kernel identities of a deepseek2 GGUF run: B2's latent form once
    a layer a decode step and a prefill chunk; B3's expert form (or its
    dequant route above 256 rows) 3 a MoE layer a pass, in its `gq` form;
    B4 once a pass with logits; no 2-D B3 product (the file's attention
    and dense MLP load as bf16)."""
    L, kd = cfg.num_layers, cfg.first_k_dense
    steps, passes = out["decode_steps"], out["admissions"] + out["prefill_chunks"]
    check(n["paged_attention_latent"] == L * (steps + out["prefill_chunks"])
          and n["paged_attention"] == 0 and n["flash_prefill"] == 0,
          f"{label}: B2 latent launches {n['paged_attention_latent']} != {L} x ({steps} + "
          f"{out['prefill_chunks']})")
    moe = n["quant_matmul_moe"] + n["moe_dequant_calls"]
    check(n["quant_matmul_moe"] > 0 and moe == 3 * (L - kd) * (steps + passes),
          f"{label}: expert launches {n['quant_matmul_moe']} + dequant {n['moe_dequant_calls']}"
          f" != 3 x {L - kd} x ({steps} + {passes})")
    check(n["quant_matmul"] == 0, f"{label}: a 2-D B3 product ran on a bf16 weight: {n}")
    check(n["quant_unembed"] == steps + out["admissions"] + out["chunked_admits"],
          f"{label}: B4 launches {n['quant_unembed']}")


def phase_gguf_deepseek() -> dict:
    """A deepseek2 GGUF at deepseek-v2-lite's full widths, GGUF_DEEPSEEK_LAYERS
    of its 27 layers, its types mixed as a Q4_K_M file mixes them
    (_deepseek_gguf_type), written from llama.cpp's layout with seeded
    random payloads: the write and the parse timed; the tree's forms
    checked (experts in grouped int8 per expert, B3's `gq` expert form,
    the head in per-channel int8 for B4); 8 requests through Engine.submit
    on the paged engine with graphs, held against the dequantized bf16
    tree with _part_gap's rule (_gguf_against_dense); then the file served
    over HTTP from a YAML `model: <file>.gguf` (4 chats, half streamed),
    the parse reused."""
    import yaml

    from localai_tpu_torch.engine import gguf as G
    from localai_tpu_torch.engine.weights import params_from_numpy
    from localai_tpu_torch.models import get_arch

    cfg = get_arch("deepseek-v2-lite")
    root = tempfile.mkdtemp(prefix="gguf-ds-")
    out: dict = {}
    try:
        path = f"{root}/deepseek-v2-lite-q4_k_m.gguf"
        t0 = time.monotonic()
        nbytes = write_gguf_deepseek(path, cfg, GGUF_DEEPSEEK_LAYERS, seed=5)
        write_s = time.monotonic() - t0
        t0 = time.monotonic()
        parsed = G.load_gguf_checkpoint(path)
        parse_s = time.monotonic() - t0
        arch, tree, tok_dir = parsed
        widths = ("vocab_size", "hidden_size", "intermediate_size", "num_heads", "kv_lora_rank",
                  "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "num_experts",
                  "num_experts_per_token", "n_shared_experts", "moe_inter_size",
                  "first_k_dense", "q_lora_rank", "tie_embeddings")
        check(all(getattr(arch, k) == getattr(cfg, k) for k in widths) and arch.is_mla
              and arch.num_layers == GGUF_DEEPSEEK_LAYERS and tok_dir is not None,
              f"gguf_deepseek: the file's arch {arch} is not deepseek-v2-lite's widths")
        E, D, F, M = cfg.num_experts, cfg.hidden_size, cfg.moe_inter_size, GGUF_DEEPSEEK_LAYERS - 1
        lay = tree["layers"]
        check(sorted(lay["w_gate"]) == ["gq", "gs"]
              and lay["w_gate"]["gq"].shape == (M, E, D // 32, 32, F)
              and lay["w_down"]["gs"].shape == (M, E, F // 32, 1, D)
              and sorted(tree["lm_head"]) == ["q", "s"],
              f"gguf_deepseek: tree forms {({k: getattr(v, 'shape', None) for k, v in lay['w_gate'].items()})}")
        t0 = time.monotonic()
        params = params_from_numpy(arch, tree, device="cuda")
        put_s = time.monotonic() - t0
        out["file"] = dict(layers=GGUF_DEEPSEEK_LAYERS, file_bytes=nbytes, write_s=write_s,
                           parse_and_repack_s=parse_s, to_card_s=put_s,
                           forms=_form_bytes(params))
        log(f"[gguf_deepseek file] {json.dumps(out['file'])}")
        run = _gguf_against_dense("deepseek-v2-lite", arch, params, GGUF_DEEPSEEK_PROMPTS,
                                  GGUF_DEEPSEEK_NEW, probe=_moe_probe)
        # The served rate of 8 slots from one graph replay's device time a step
        # (the run's own decode_tok_s includes its blocks' first captures).
        run["device_tok_s_8_slots"] = 8e3 / run["probe"]["device_ms_per_step"]
        _check_graphs("gguf_deepseek", run)
        _check_gguf_deepseek_launches("gguf_deepseek engine", arch, run, run["launches"])
        run.pop("ids")
        out["engine"] = run
        log(f"[gguf_deepseek engine] {json.dumps(run)}")
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # The same file over HTTP from its YAML (the manager's loader handed
        # the parse above: the file is the same).
        with open(f"{root}/ds-gguf.yaml", "w") as f:
            yaml.safe_dump({"name": "ds-gguf", "model": os.path.basename(path), **GGUF_YAML}, f)
        manager, server, base = _start_server(root)
        try:
            t0 = time.monotonic()
            with swapped(G, "load_gguf_checkpoint", lambda _p: parsed):
                eng = manager.get("ds-gguf").engine
            load_s = time.monotonic() - t0
            reqs = [("/v1/chat/completions", "ds-gguf", {
                "model": "ds-gguf", "max_tokens": GGUF_DEEPSEEK_HTTP_NEW, "ignore_eos": True,
                "stream": i % 2 == 1, "temperature": 0.0 if i < 2 else 0.8, "seed": 40 + i,
                "messages": [{"role": "user", "content": _gguf_text(n, 40 + i)}]})
                for i, n in enumerate((150, 600, 1200, 2400))]
            m0 = eng.metrics()
            _zero_counts()
            results, wall = _http_batch(base, reqs)
            n = _read_counts()
            m1 = eng.metrics()
            _texts, ttfts = _check_http_results("gguf_deepseek http", reqs, results,
                                                n_tokens=GGUF_DEEPSEEK_HTTP_NEW)
            d = {k: int(m1[k] - m0[k]) for k in ("decode_steps", "admissions", "prefill_chunks",
                                                  "chunked_admits", "decode_blocks",
                                                  "decode_graph_captures",
                                                  "decode_graph_replays")}
            _check_graphs("gguf_deepseek http", d)
            _check_gguf_deepseek_launches("gguf_deepseek http", eng.cfg, d, n)
            out["http"] = dict(requests=len(reqs), wall_s=wall, load_s=load_s,
                               stream_ttft_ms=[t * 1e3 for t in ttfts], launches=n, **d)
            log(f"[gguf_deepseek http] {json.dumps(out['http'])}")
        finally:
            server.shutdown()
            manager.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["summary"] = dict(
        file=_compact(out["file"], ("file_bytes", "write_s", "parse_and_repack_s", "to_card_s")),
        engine=_compact(out["engine"], ("decode_tok_s", "device_tok_s_8_slots", "probe",
                                        "ttft_ms_p50", "weight_bytes", "launches")),
        greedy_parted=len(out["engine"]["greedy_vs_dense"]["parted"]),
        http_load_s=out["http"]["load_s"])
    log(f"[gguf_deepseek summary] {json.dumps(out['summary'])}")
    return out


EXPERT_LORA_RANK = 16
EXPERT_LORA_PROMPTS = [20, 100, 300, 700, 1500, 20, 100, 300]
EXPERT_LORA_NEW = 32


def _mixtral_hf_shapes(cfg) -> dict[str, tuple]:
    """Every tensor of a Mixtral HF checkpoint of cfg ([out, in] linears)."""
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Q, K = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    s = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,),
         "lm_head.weight": (V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        s.update({p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,),
                  p + "self_attn.q_proj.weight": (Q, D), p + "self_attn.k_proj.weight": (K, D),
                  p + "self_attn.v_proj.weight": (K, D), p + "self_attn.o_proj.weight": (D, Q),
                  p + "block_sparse_moe.gate.weight": (cfg.num_experts, D)})
        for e in range(cfg.num_experts):
            q = f"{p}block_sparse_moe.experts.{e}."
            s.update({q + "w1.weight": (F, D), q + "w3.weight": (F, D), q + "w2.weight": (D, F)})
    return s


def _greedy_ids(eng, prompts, new) -> tuple[list, dict]:
    """Greedy requests through Engine.submit, the counts zeroed just before
    and read just after: (each request's ids, the counts)."""
    from localai_tpu_torch.engine.engine import GenRequest

    _zero_counts()
    handles = [eng.submit(GenRequest(prompt_ids=p, max_new_tokens=new, ignore_eos=True))
               for p in prompts]
    ids = [[ev.token_id for ev in h if ev.kind == "token"] for h in handles]
    return ids, _read_counts()


def phase_expert_lora() -> dict:
    """A Mixtral-8x7b HF checkpoint at full width, 1 of its 32 layers
    (seeded random bf16, written on the host), and a rank-16 PEFT adapter on
    that layer's every expert w1 / w3 / w2 and on q_proj / v_proj, loaded
    with quantize="int4" and the adapter merged (timed). A second checkpoint
    holds the same tensors with the loader's deltas added beforehand (f32,
    cast to bf16) and loads with quantize="int4" and no adapter (timed):
    every int4 payload, scale and zero point of the merged projections
    equals its, bit for bit, and 8 greedy requests through B3's expert form
    give the same ids on both trees."""
    from localai_tpu_torch.engine import weights as W
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch

    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), num_layers=1)
    E, R = cfg.num_experts, EXPERT_LORA_RANK
    gen = torch.Generator(device="cuda").manual_seed(23)
    root = tempfile.mkdtemp(prefix="expert-lora-")
    out: dict = {}
    try:
        ckpt, adir = f"{root}/ckpt", f"{root}/adapter"
        os.makedirs(ckpt)
        shapes = _mixtral_hf_shapes(cfg)
        t0 = time.monotonic()
        W.write_safetensors(
            f"{ckpt}/model.safetensors", shapes, torch.bfloat16,
            lambda k: (torch.ones(shapes[k], device="cuda") if len(shapes[k]) == 1 else
                       torch.randn(shapes[k], generator=gen, device="cuda") * 0.02))
        with open(f"{ckpt}/config.json", "w") as f:
            json.dump({"model_type": "mixtral", "vocab_size": cfg.vocab_size,
                       "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                       "num_hidden_layers": 1, "num_attention_heads": cfg.num_heads,
                       "num_key_value_heads": cfg.num_kv_heads, "num_local_experts": E,
                       "num_experts_per_tok": cfg.num_experts_per_token,
                       "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
                       "max_position_embeddings": cfg.max_position,
                       "tie_word_embeddings": False}, f)
        write_s = time.monotonic() - t0
        arch = W.arch_from_hf_config(ckpt)
        check(arch.is_moe and arch.num_experts == E and arch.hidden_size == cfg.hidden_size,
              f"expert_lora: the checkpoint's arch {arch}")
        rng = np.random.default_rng(29)
        D, F, Q, K = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads * cfg.head_dim_, \
            cfg.num_kv_heads * cfg.head_dim_
        mods = [(f"block_sparse_moe.experts.{e}.{w}", (F, D) if w != "w2" else (D, F))
                for e in range(E) for w in ("w1", "w3", "w2")]
        mods += [("self_attn.q_proj", (Q, D)), ("self_attn.v_proj", (K, D))]
        factors = {}
        for mod, (d_out, d_in) in mods:
            pre = f"base_model.model.model.layers.0.{mod}"
            factors[f"{pre}.lora_A.weight"] = rng.normal(0, 0.02, (R, d_in)).astype(np.float32)
            factors[f"{pre}.lora_B.weight"] = rng.normal(0, 0.02, (d_out, R)).astype(np.float32)
        W.save_lora_adapter(adir, factors, R, R)
        t0 = time.monotonic()
        merged = W.load_hf_checkpoint(arch, ckpt, device="cuda", quantize="int4",
                                      lora=[(adir, 1.0)])
        load_s = time.monotonic() - t0

        # The pre-merged checkpoint: the loader's deltas added in f32 on the host
        # side to the checkpoint's tensors, cast to bf16 and written as a
        # second checkpoint, loaded with quantize="int4" and no adapter. Each
        # merged projection's payloads equal its payloads bit for bit.
        t0 = time.monotonic()
        deltas = W.load_lora_deltas(adir, 1.0, arch)
        st = W.SafetensorsFile(f"{ckpt}/model.safetensors")
        adapted, changed = {}, {}
        for our, names in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2"),
                           ("wq", "q_proj"), ("wv", "v_proj")):
            if our.startswith("w_"):
                for e in range(E):
                    adapted[f"model.layers.0.block_sparse_moe.experts.{e}.{names}.weight"] = \
                        (our, deltas[our][(0, e)])
            else:
                adapted[f"model.layers.0.self_attn.{names}.weight"] = (our, deltas[our][0])
        moved = {our: [] for our, _d in adapted.values()}

        def pre_merged(name: str) -> torch.Tensor:
            base = st.get(name).cuda()
            if name not in adapted:
                return base
            our, d = adapted[name]
            pre = (base.float() + torch.from_numpy(d).cuda().t()).to(torch.bfloat16)
            moved[our].append(float((pre != base).float().mean()))
            return pre

        pdir = f"{root}/pre_merged"
        os.makedirs(pdir)
        shutil.copy(f"{ckpt}/config.json", pdir)
        W.write_safetensors(f"{pdir}/model.safetensors", shapes, torch.bfloat16, pre_merged)
        del deltas, st
        pre_write_s = time.monotonic() - t0
        t0 = time.monotonic()
        pre_tree = W.load_hf_checkpoint(arch, pdir, device="cuda", quantize="int4")
        pre_load_s = time.monotonic() - t0
        equal = {our: all(torch.equal(merged["layers"][our][k], v)
                          for k, v in pre_tree["layers"][our].items())
                 for our in moved}
        changed = {our: sum(v) / len(v) for our, v in moved.items()}
        check(all(equal.values()), f"expert_lora: merged int4 payloads differ from the "
                                   f"pre-merged checkpoint's: {equal}")
        check(all(c > 0.1 for c in changed.values()),
              f"expert_lora: a delta moved few bf16 weights: {changed}")

        prompts = _serve_prompts(EXPERT_LORA_PROMPTS)
        runs = {}
        for label, tree in (("merged", merged), ("pre_merged", pre_tree)):
            eng = Engine(arch, tree, ByteTokenizer(arch.vocab_size), device="cuda",
                         engine_cfg=EngineConfig(**PAGED_ENGINE))
            eng.start()
            try:
                t0 = time.monotonic()
                ids, n = _greedy_ids(eng, prompts, EXPERT_LORA_NEW)
                wall = time.monotonic() - t0
            finally:
                eng.stop()
            check(all(len(x) == EXPERT_LORA_NEW for x in ids) and n["quant_matmul_moe"] > 0
                  and n["quant_matmul_g4"] > 0,
                  f"expert_lora {label}: ids {[len(x) for x in ids]}, launches {n}")
            runs[label] = dict(ids=ids, wall_s=wall, launches=n)
        check(runs["merged"]["ids"] == runs["pre_merged"]["ids"],
              "expert_lora: the merged tree's greedy ids differ from the pre-merged tree's")
        out = dict(write_s=write_s, load_s=load_s, pre_merged_write_s=pre_write_s,
                   pre_merged_load_s=pre_load_s, rank=R,
                   payloads_equal=equal, weights_moved=changed,
                   launches=runs["merged"]["launches"], wall_s=runs["merged"]["wall_s"],
                   ids_equal=True)
        log(f"[expert_lora] {json.dumps(out)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 36. audio: whisper, the TTS voices, the VADs and the realtime socket
# --------------------------------------------------------------------------- #

AUDIO_SPEECH_S = (30.0, 75.0)  # 1 and 3 whisper chunks
AUDIO_COS_MIN = 0.999  # the bf16 whisper encoder's states against the f32 witness
VITS_COS_MIN = 0.999  # the card's VITS waveform against the CPU's f32 witness
REALTIME_NEW = 16  # tokens the realtime turn decodes
REALTIME_APPEND_S = 0.1  # a realtime client's pcm16 chunk, sent at this pace
BUSY_SPEECH_S = 45.0  # the transcription posted under chats: 2 chunks
BUSY_CHATS = 4
BUSY_CHAT_NEW = 2048  # tokens a busy chat decodes (~8 s of the 4-layer 1b at 4 slots)
VAD_STREAM_S = 30.0  # speech the streaming VAD takes in 100 ms pushes
VAD_SEG_TOL_S = 0.02  # its segments' ends against detect()'s: two 10 ms frames (rounding)


def _formant_speech(seconds: float, seed: int, sr: int = 16_000,
                    with_end: bool = False) -> np.ndarray | tuple[np.ndarray, float]:
    """Formant-synthesized speech of `seconds` (utterances of up to 6 s with
    pauses between them), at sr; `with_end` adds the second at which the
    last voiced sample ends (the synthesizer's own labels)."""
    from localai_tpu_torch.audio.formant_speech import synth_utterance
    from localai_tpu_torch.audio.wav import resample

    rng = np.random.default_rng(seed)
    parts, labels, n = [], [], 0.0
    while n < seconds:
        d = min(6.0, seconds - n)
        x, label = synth_utterance(rng, d, 16_000)
        parts.append(x)
        labels.append(label)
        n += d
    x = np.concatenate(parts)[: int(seconds * 16_000)]
    x = resample(x, 16_000, sr) if sr != 16_000 else x
    if not with_end:
        return x
    voiced = np.flatnonzero(np.concatenate(labels)[: int(seconds * 16_000)] > 0)
    return x, (int(voiced[-1]) + 1) / 16_000


class _WsClient:
    """A minimal RFC 6455 client over a raw socket (masked frames)."""

    def __init__(self, base: str, path: str):
        import base64

        host, port = base.split("//")[1].split(":")
        self.sock = socket.create_connection((host, int(port)), timeout=600)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        self.f = self.sock.makefile("rb")
        status = self.f.readline().decode()
        check("101" in status, f"realtime: handshake answered {status!r}")
        while self.f.readline().strip():
            pass

    def send(self, obj: dict) -> None:
        payload = json.dumps(obj).encode()
        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x81]) + (bytes([0x80 | n]) if n < 126 else
                                bytes([0x80 | 126]) + struct.pack(">H", n) if n < 1 << 16 else
                                bytes([0x80 | 127]) + struct.pack(">Q", n))
        body = (np.frombuffer(payload, np.uint8)
                ^ np.resize(np.frombuffer(mask, np.uint8), n)).tobytes()
        self.sock.sendall(head + mask + body)

    def recv(self) -> dict:
        while True:
            b1, b2 = self.f.read(2)
            ln = b2 & 0x7F
            if ln == 126:
                (ln,) = struct.unpack(">H", self.f.read(2))
            elif ln == 127:
                (ln,) = struct.unpack(">Q", self.f.read(8))
            payload = self.f.read(ln)
            if b1 & 0x0F == 0x1:
                return json.loads(payload)
            check(b1 & 0x0F != 0x8, "realtime: the server closed the socket")

    def close(self) -> None:
        self.sock.close()


def _post_raw(base: str, path: str, body: bytes, ctype: str) -> tuple[int, str, bytes, float]:
    import urllib.error
    import urllib.request

    t0 = time.monotonic()
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, r.headers.get("Content-Type"), r.read(), time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read(), time.monotonic() - t0


def _multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "smoke" + os.urandom(8).hex()
    parts = []
    for name, (fname, blob) in fields.items():
        disp = f'form-data; name="{name}"' + (f'; filename="{fname}"' if fname else "")
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n".encode() + blob
                     + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


def _forced_logits(cfg, params, enc, seq: list[int]) -> torch.Tensor:
    """Whisper's logits after teacher-forcing `seq` (B = 1): the first step
    eager, the rest replays of one captured decode step over static token
    and position buffers (whisper.capture_graph: the engines' capture
    stream, lock and thread-local mode)."""
    from localai_tpu_torch.models import whisper as W

    with torch.no_grad():
        xk, xv = W.cross_kv(cfg, params, enc)
        cache = W.SelfCache.zeros(cfg, 1, "cuda")
        seq_d = torch.tensor(seq, device="cuda")
        step = torch.zeros((1,), dtype=torch.int64, device="cuda")
        logits = torch.zeros((1, cfg.vocab_size), device="cuda")

        def forced_step():
            logits.copy_(W.decode_step(cfg, params, seq_d[step], step, cache, xk, xv)[0])
            step.add_(1)

        graph = W.capture_graph(torch.device("cuda"), forced_step)  # runs the first step
        for _ in range(len(seq) - 1):
            graph.replay()
        return logits[0].clone()


def _whisper_witness(weng, mel) -> dict:
    """The served bf16 whisper on one 30 s chunk against the f32 witness on
    the same weights: the encoder's states by cosine, the greedy ids equal
    or parting where the witness is at a near tie (its logits at the
    parting step, teacher-forced on the bf16 ids: the gap of the two
    choices within PREFIX_LOGIT_TOL of the largest |logit|); the encoder's
    device time, and the decode's: CUDA events around the engine's own B =
    1 step graphs (captured by the first 30 s request) replaying the 4
    prompt and 192 greedy steps."""
    from localai_tpu_torch.models import whisper as W

    wcfg, params = weng.cfg, weng.params
    prompt = [wcfg.sot_id, wcfg.first_lang_id, wcfg.transcribe_id, wcfg.no_timestamps_id]
    f32cfg = dataclasses.replace(wcfg, dtype="float32")
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    steps = weng.MAX_NEW_TOKENS
    with torch.no_grad():
        enc = W.encode(wcfg, params, mel)
        enc32 = W.encode(f32cfg, p32, mel)
        cos = float(torch.nn.functional.cosine_similarity(enc.float().flatten(),
                                                          enc32.flatten(), dim=0))
        enc_ms = cuda_time_ms(lambda: W.encode(wcfg, params, mel), reps=5)
        with weng._lock:
            captures = weng.graphs.captures
            toks, nv = W.transcribe_greedy(wcfg, params, mel, prompt, steps, graphs=weng.graphs)
            decode_ms, replays = weng.graphs.decode_ms(), weng.graphs.steps_last
            check(weng.graphs.captures == captures and replays == steps + len(prompt),
                  f"audio: the witness's request captured {weng.graphs.captures - captures} "
                  f"graphs, or ran {replays} steps, not {steps + len(prompt)}")
        toks32, _ = W.transcribe_greedy(f32cfg, p32, mel, prompt, steps)
        # The graph replays against eager decode steps: the first 8 tokens.
        xk, xv = W.cross_kv(wcfg, params, enc)
        cache = W.SelfCache.zeros(wcfg, 1, "cuda")
        eager, tok = [], None
        for i in range(len(prompt) + 8):
            t = prompt[i] if i < len(prompt) else tok
            logits, cache = W.decode_step(wcfg, params, torch.tensor([t], device="cuda"),
                                          torch.tensor([i], device="cuda"), cache, xk, xv)
            tok = int(logits[0].argmax())
            if i >= len(prompt) - 1 and len(eager) < 8:
                eager.append(tok)
    check(eager == toks[0, :8].tolist(), f"audio: whisper's graph replays gave "
                                          f"{toks[0, :8].tolist()}, eager steps {eager}")
    got, want = toks[0].tolist(), toks32[0].tolist()
    part = None
    if got != want:
        p = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
        lg = _forced_logits(f32cfg, p32, enc32, prompt + got[:p])
        part = dict(position=p, want=want[p], got=got[p],
                    gap=abs(float(lg[want[p]] - lg[got[p]])),
                    bound=PREFIX_LOGIT_TOL * float(lg.abs().max()))
        check(part["gap"] <= part["bound"], f"audio: whisper's bf16 greedy ids part from the "
                                            f"f32 witness's beyond a near tie: {part}")
    check(cos >= AUDIO_COS_MIN, f"audio: whisper encoder cosine {cos} < {AUDIO_COS_MIN}")
    del p32, enc32
    torch.cuda.empty_cache()
    return dict(encoder_cosine=cos, encoder_ms=enc_ms, decode_steps=replays,
                decode_steps_ms=decode_ms, decode_ms_per_token=decode_ms / replays,
                ids_equal=part is None, parted=part, n_valid=int(nv[0]))


def _whisper_busy(base: str, weng, speech16: np.ndarray) -> dict:
    """Transcriptions posted while BUSY_CHATS streamed greedy chats decode on
    the same server: 30 s (1 chunk, its graphs captured by an earlier
    request: replays only), then 45 s (2 chunks, a count no request had:
    whisper captures its encoder and step graphs while the chat engine's
    loop thread launches, allocates and synchronizes), after a short round
    of the same chats has captured the chat engine's first blocks. Every
    chat ends with its tokens and no error and is in flight across the 30
    s request and at the 45 s request's post; the 30 s ids equal an idle
    request's, the 45
    s request captured its two graphs once, and the same 45 s again on the
    idle server replays them with the same ids."""
    from localai_tpu_torch.audio.wav import write_wav

    def post(seconds: float) -> tuple[dict, float, int, float]:
        body, ctype = _multipart({
            "file": ("speech.wav", write_wav(speech16[: int(seconds * 16_000)], 16_000)),
            "model": (None, b"whisper"), "response_format": (None, b"verbose_json")})
        captures = weng.graphs.captures
        t_post = time.monotonic()
        status, _ct, raw, wall = _post_raw(base, "/v1/audio/transcriptions", body, ctype)
        check(status == 200, f"audio: a {seconds} s transcription answered {status}: {raw[:300]}")
        return json.loads(raw), wall, weng.graphs.captures - captures, t_post

    def ids(res: dict) -> list:
        return [s["tokens"] for s in res["segments"]]

    idle30, idle30_wall, _c, _t = post(30.0)
    results: list = [None] * BUSY_CHATS
    stamps: list = [[] for _ in range(BUSY_CHATS)]

    def chat(i: int, n: int = BUSY_CHAT_NEW) -> None:
        req = {"model": "chat", "messages": [{"role": "user", "content": _obs_text(60, 900 + i)}],
               "max_tokens": n, "ignore_eos": True, "temperature": 0.0, "stream": True}
        results[i] = _http(base, "/v1/chat/completions", req, time.monotonic(), stamps[i])

    # A short round first: the chat engine captures its first blocks' graphs.
    warm = [threading.Thread(target=chat, args=(i, 64), daemon=True) for i in range(BUSY_CHATS)]
    for th in warm:
        th.start()
    for th in warm:
        th.join(timeout=300)
    stamps = [[] for _ in range(BUSY_CHATS)]
    threads = [threading.Thread(target=chat, args=(i,), daemon=True) for i in range(BUSY_CHATS)]
    for th in threads:
        th.start()
    t0 = time.monotonic()
    while min(len(x) for x in stamps) < 2:  # every chat decoding
        check(time.monotonic() - t0 < 120, "audio: the busy chats never started")
        time.sleep(0.005)
    busy30, busy30_wall, c30, t30 = post(30.0)
    busy45, busy45_wall, c45, t45 = post(BUSY_SPEECH_S)
    for th in threads:
        th.join(timeout=600)
    for i, c in enumerate(results):
        check(c is not None and c["status"] == 200 and c["frames"][-1] == "[DONE]"
              and not any('"error"' in f for f in c["frames"]),
              f"audio: busy chat {i} ended {c and c['status']}")
        usage = json.loads(c["frames"][-2])["usage"]
        check(usage["completion_tokens"] == BUSY_CHAT_NEW, f"audio: busy chat {i}: {usage}")
    # Every chat in flight (a frame before and after) across the 30 s request,
    # and one still in flight when the 45 s request was posted.
    during30 = [sum(t30 < t <= t30 + busy30_wall for t in x) for x in stamps]
    after45 = [sum(t > t45 for t in x) for x in stamps]
    check(all(x[0] < t30 and x[-1] > t30 + busy30_wall for x in stamps) and max(after45) > 0,
          f"audio: the chats were not in flight across the busy transcriptions: frames during "
          f"the 30 s one {during30}, after the 45 s one's post {after45}")
    check(c30 == 0 and c45 == 2, f"audio: the busy transcriptions captured {c30} and {c45} "
                                 f"graphs, not 0 and 2 (the encoder, one step)")
    check(ids(busy30) == ids(idle30), "audio: the 30 s transcription under chats differs "
                                      "from the idle one")
    idle45, idle45_wall, c_idle, _t = post(BUSY_SPEECH_S)
    check(c_idle == 0 and ids(idle45) == ids(busy45) and len(busy45["segments"]) == 2,
          f"audio: the idle 45 s rerun captured {c_idle} graphs or gave other ids")
    return dict(chats=BUSY_CHATS, chat_tokens=BUSY_CHAT_NEW, idle_30s_wall_s=idle30_wall,
                busy_30s_wall_s=busy30_wall, busy_45s_capture_wall_s=busy45_wall,
                idle_45s_wall_s=idle45_wall, chat_frames_during_30s=during30,
                chat_frames_after_45s_post=after45, ids_equal=True)


def _vad_stream_bench(seconds: float = VAD_STREAM_S) -> dict:
    """The packaged VAD net on the card as the realtime socket runs it: a
    StreamingDetector given `seconds` of 24 kHz formant speech in 100 ms
    pushes (wall ms a push, its host read included), against detect() of
    the whole buffer at the end (segments equal within VAD_SEG_TOL_S, and
    its wall ms: what every append cost when the socket reran it)."""
    from localai_tpu_torch.audio import learned_vad as LV
    from localai_tpu_torch.audio.wav import resample

    p = LV.load_params(LV.packaged_weights(), device="cuda")
    cfg = LV.config_from_params(p)
    x = _formant_speech(seconds, 79, 24_000)
    det, ms = LV.StreamingDetector(24_000), []
    for i in range(0, len(x), 2400):
        t0 = time.perf_counter()
        got = det.push(cfg, p, x[i: i + 2400])
        ms.append((time.perf_counter() - t0) * 1e3)
    x16 = resample(x, 24_000, 16_000)
    t0 = time.perf_counter()
    want = LV.detect(cfg, p, x16, 16_000)
    whole_ms = (time.perf_counter() - t0) * 1e3
    check(len(got) == len(want) and len(got) > 0
          and all(abs(a.start - b.start) <= VAD_SEG_TOL_S and abs(a.end - b.end) <= VAD_SEG_TOL_S
                  for a, b in zip(got, want)),
          f"audio: the streaming VAD's {len(got)} segments differ from detect()'s {len(want)}")
    med = statistics.median
    first, last = med(ms[10:60]), med(ms[-50:])
    check(last <= 2 * first + 1.0, f"audio: the streaming VAD's push grew from {first:.3f} ms "
                                   f"to {last:.3f} ms over {seconds} s")
    return dict(seconds=seconds, pushes=len(ms), push_ms_median_first=first,
                push_ms_median_last=last, push_ms_max=max(ms), push_ms_mean=sum(ms) / len(ms),
                recomputes=det.recomputes, segments=len(got), whole_buffer_detect_ms=whole_ms)


def _vits_witness(eng) -> dict:
    """The served VITS voice on the card (f32 weights) against the same
    synthesis in f32 on the CPU under the same noise tensors: valid samples
    equal, the waveform's cosine; ms per second of speech on the card."""
    from localai_tpu_torch.models import vits as V

    ids = eng.tokenizer.encode("hello")  # 11 ids: a 256-frame budget, light on the CPU
    tb, frames = eng.buckets(len(ids), 1.0)
    pad = torch.zeros((1, tb), dtype=torch.int64)
    pad[0, : len(ids)] = torch.tensor(ids)
    dur, prior = eng.noise(1234, tb, frames)
    n_tok = torch.tensor([len(ids)])

    def run(device, params):
        return V.synthesize(eng.cfg, params, pad.to(device), frames, dur.to(device),
                            prior.to(device), n_tokens=n_tok.to(device))

    wav, n = run("cuda", eng.params)
    cpu = {k: v.cpu() for k, v in eng.params.items()}
    wav32, n32 = run("cpu", cpu)
    nv = int(n[0])
    check(nv == int(n32[0]) and nv > 0, f"audio: VITS valid samples {nv} on the card, "
                                        f"{int(n32[0])} on the CPU")
    a, b = wav[0, :nv].float().cpu(), wav32[0, :nv]
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    check(cos >= VITS_COS_MIN, f"audio: VITS waveform cosine {cos} < {VITS_COS_MIN}")
    # The card's time for a sentence at the served text's size.
    long_text = "the port speaks on the card, and a second clause follows the first."
    torch.cuda.synchronize()
    t0 = time.monotonic()
    samples, sr = eng.synthesize(long_text)
    ms = (time.monotonic() - t0) * 1e3
    return dict(tokens=len(ids), token_bucket=tb, frames=frames, valid_samples=nv,
                cosine=cos, max_abs_err=float((a - b).abs().max()),
                timed_tokens=len(eng.tokenizer.encode(long_text)),
                timed_buckets=eng.buckets(len(eng.tokenizer.encode(long_text)), 1.0),
                ms=ms, speech_s=len(samples) / sr, ms_per_speech_s=ms / (len(samples) / sr))


def _realtime_round_trip(base: str, rt) -> dict:
    """One realtime turn over /v1/realtime as a client streams it: server VAD
    (the vad model), 3 s of pcm16 formant speech at 24 kHz and then 1 s of
    silence, in REALTIME_APPEND_S appends sent at that pace by a thread of
    their own. The server commits once 500 ms of silence follow the speech,
    transcribes with whisper, runs the 1b's turn and speaks it with the
    VITS voice. Times from the send of the last speech append (the end of
    speech, as the user feels it: the 500 ms the server waits for silence
    included; the append that carries the synthesizer's last voiced
    sample) and from speech_stopped (the server's commit) to the first
    response.audio.delta, broken into the transcription, the turn's TTFT
    and the TTS; the VAD's ms on each append (rt.vad_ms, the server's own
    clock)."""
    import base64

    ws = _WsClient(base, "/v1/realtime?model=chat")
    try:
        check(ws.recv()["type"] == "session.created", "realtime: no session.created")
        ws.send({"type": "session.update", "session": {
            "turn_detection": {"type": "server_vad", "silence_duration_ms": 500},
            "temperature": 0.0, "max_response_output_tokens": REALTIME_NEW,
            "transcription_model": "whisper", "tts_model": "vits",
            "modalities": ["text", "audio"]}})
        check(ws.recv()["type"] == "session.updated", "realtime: no session.updated")
        # A text turn first: the 1b's decode-block graphs are captured before
        # the timed turn (as on a server that has answered once).
        ws.send({"type": "conversation.item.create", "item": {
            "type": "message", "role": "user",
            "content": [{"type": "input_text", "text": "warm up"}]}})
        ws.send({"type": "response.create", "response": {"modalities": ["text"]}})
        while ws.recv()["type"] != "response.done":
            pass
        speech, voiced_end = _formant_speech(3.0, 77, 24_000, with_end=True)
        pcm = (np.clip(np.concatenate([speech, np.zeros(24_000, np.float32)]), -1, 1)
               * 32767).astype(np.int16)
        chunk = int(24_000 * REALTIME_APPEND_S)
        n_speech = -(-len(speech) // chunk)
        k_end = int(voiced_end / REALTIME_APPEND_S)  # the append with the last voiced sample
        sent: list = []

        def sender() -> None:
            t_next = time.monotonic()
            for i in range(0, len(pcm), chunk):
                time.sleep(max(0.0, t_next - time.monotonic()))
                ws.send({"type": "input_audio_buffer.append",
                         "audio": base64.b64encode(pcm[i: i + chunk].tobytes()).decode()})
                sent.append(time.monotonic())
                t_next += REALTIME_APPEND_S

        rt.vad_ms.clear()
        _zero_counts()
        th = threading.Thread(target=sender, daemon=True, name="realtime-sender")
        th.start()
        stamps, events, audio_bytes = {}, [], 0
        while True:
            ev = ws.recv()
            now = time.monotonic()
            events.append(ev["type"])
            key = ev["type"]
            if key == "response.audio_transcript.delta":
                stamps.setdefault("first_delta", now)
                stamps["last_delta"] = now
            else:
                stamps.setdefault(key, now)
            if key == "response.audio.delta":
                audio_bytes += len(base64.b64decode(ev["delta"]))
            if key == "error":
                fail(f"realtime: error event {ev}")
            if key == "response.done":
                break
        n = _read_counts()
        th.join(timeout=60)
        # Every append reached the session (they are handled in order): the
        # silence after the commit starts no turn.
        ws.send({"type": "input_audio_buffer.clear"})
        check(ws.recv()["type"] == "input_audio_buffer.cleared",
              "realtime: the appends after the turn raised an event")
        vad = list(rt.vad_ms)
    finally:
        ws.close()
    order = ["input_audio_buffer.speech_started", "input_audio_buffer.speech_stopped",
             "input_audio_buffer.committed", "conversation.item.created", "response.created",
             "response.audio.delta", "response.audio.done", "response.done"]
    check(all(k in stamps for k in order) and [k for k in events if k in order] ==
          [k for k in order for _ in range(events.count(k))],
          f"realtime: events {events}")
    check(n["flash_prefill"] > 0 and n["paged_attention"] > 0,
          f"realtime: the turn missed B1 or B2: {n}")
    check(len(vad) == len(sent), f"realtime: {len(vad)} VAD runs for {len(sent)} appends")
    t = stamps
    vms = [ms for _s, ms in vad]
    out = dict(events=len(events), appends=len(sent), append_s=REALTIME_APPEND_S,
               voiced_end_s=voiced_end, audio_out_s=audio_bytes / 2 / 24_000,
               end_of_speech_to_first_audio_ms=(t["response.audio.delta"] - sent[k_end]) * 1e3,
               end_of_speech_to_stopped_ms=(t["input_audio_buffer.speech_stopped"]
                                            - sent[k_end]) * 1e3,
               commit_to_first_audio_ms=(t["response.audio.delta"]
                                         - t["input_audio_buffer.speech_stopped"]) * 1e3,
               transcription_ms=(t["input_audio_buffer.committed"]
                                 - t["input_audio_buffer.speech_stopped"]) * 1e3,
               turn_ttft_ms=(t.get("first_delta", t["response.audio.delta"])
                             - t["response.created"]) * 1e3,
               turn_ms=(t.get("last_delta", t["response.created"]) - t["response.created"]) * 1e3,
               tts_ms=(t["response.audio.delta"] - t.get("last_delta", t["response.created"]))
               * 1e3,
               vad_ms_per_append=dict(mean=sum(vms) / len(vms), max=max(vms),
                                      first_10=statistics.median(vms[:10]),
                                      speech_last_10=statistics.median(vms[n_speech - 10:n_speech]),
                                      buffer_s_max=max(s for s, _ms in vad)),
               launches=n)
    log(f"[audio realtime] {json.dumps(out)}")
    return out


def phase_audio() -> dict:
    """Audio on the card through the port's server: whisper-large-v3 at full
    width and depth (bf16, seeded random weights, a checkpoint written by
    save_hf_whisper) transcribing 30 s and 75 s of formant speech (1 and 3
    chunks) through /v1/audio/transcriptions, held to its f32 witness
    (_whisper_witness), and 30 s and 45 s posted under streamed chats
    (_whisper_busy); a VITS voice at MMS-TTS-eng's widths (a checkpoint
    directory of seeded random weights) and tts-base through
    /v1/audio/speech and /v1/audio/speech/stream, the VITS waveform held to
    its CPU f32 witness (_vits_witness) and tts-base's Griffin-Lim timed;
    /v1/vad with the packaged learned VAD, and its streaming form over 30 s
    (_vad_stream_bench); then one realtime round trip in 100 ms appends
    (_realtime_round_trip: whisper, the 4-layer 1b's turn through B1 and
    B2, the VITS voice)."""
    import yaml

    from localai_tpu_torch.audio.wav import read_wav, write_wav
    from localai_tpu_torch.models import tts as T
    from localai_tpu_torch.models import vits as V
    from localai_tpu_torch.models import whisper as W

    root = tempfile.mkdtemp(prefix="audio-")
    out: dict = {}
    try:
        wcfg = dataclasses.replace(W.WHISPER_PRESETS["whisper-large-v3"], dtype="bfloat16")
        t0 = time.monotonic()
        wparams = W.init_params(wcfg, seed=31, device="cuda")
        # (the directory's name is no preset's: the manager reads the checkpoint)
        W.save_hf_whisper(wcfg, wparams, f"{root}/whisper-large-v3-bf16", dtype=torch.bfloat16)
        del wparams
        torch.cuda.empty_cache()
        out["whisper_write_s"] = time.monotonic() - t0
        vcfg = V.VitsConfig()  # MMS-TTS-eng's widths
        V.save_vits(vcfg, V.init_params(vcfg, seed=37, device="cuda"), f"{root}/mms-tts-eng",
                    "abcdefghijklmnopqrstuvwxyz '-")
        docs = [{"name": "whisper", "backend": "whisper", "model": "whisper-large-v3-bf16"},
                {"name": "vits", "backend": "tts", "model": "mms-tts-eng"},
                {"name": "tts-base", "backend": "tts", "model": "tts-base"},
                {"name": "vad", "backend": "vad"},
                dict(LORA_BASE_YAML, name="chat", max_tokens=REALTIME_NEW)]
        for d in docs:
            with open(f"{root}/{d['name']}.yaml", "w") as f:
                yaml.safe_dump(d, f)
        manager, server, base = _start_server(root, audio=True)
        try:
            t0 = time.monotonic()
            weng = manager.get("whisper").engine
            out["whisper_load_s"] = time.monotonic() - t0
            check(weng.cfg.dtype == "bfloat16" and weng.cfg.enc_layers == 32,
                  f"audio: whisper served as {weng.cfg}")
            trans = []
            speech16 = _formant_speech(max(AUDIO_SPEECH_S), 75)  # its heads are the shorter inputs
            for seconds in AUDIO_SPEECH_S:
                blob = write_wav(speech16[: int(seconds * 16_000)], 16_000)
                body, ctype = _multipart({"file": ("speech.wav", blob),
                                          "model": (None, b"whisper"),
                                          "response_format": (None, b"verbose_json")})
                status, _ct, raw, wall = _post_raw(base, "/v1/audio/transcriptions", body, ctype)
                check(status == 200, f"audio: transcription answered {status}: {raw[:300]}")
                res = json.loads(raw)
                chunks = int(np.ceil(seconds * 16_000 / weng.chunk_samples))
                check(len(res["segments"]) == chunks and abs(res["duration"] - seconds) < 1e-3,
                      f"audio: {seconds} s gave {len(res['segments'])} segments")
                trans.append(dict(seconds=seconds, chunks=chunks, wall_s=wall,
                                  tokens=[len(s["tokens"]) for s in res["segments"]]))
            out["transcriptions"] = trans
            mel = weng.mels(speech16[: 30 * 16_000])[:1]
            out["whisper"] = _whisper_witness(weng, mel)
            log(f"[audio whisper] {json.dumps(out['whisper'])}")
            manager.get("chat")
            out["busy"] = _whisper_busy(base, weng, speech16)
            log(f"[audio busy] {json.dumps(out['busy'])}")

            speech = {}
            for model, text in (("vits", "hello from the card. the voice is random."),
                                ("tts-base", "hello from the card")):
                for path in ("/v1/audio/speech", "/v1/audio/speech/stream"):
                    status, ct, raw, wall = _post_raw(
                        base, path, json.dumps({"model": model, "input": text}).encode(),
                        "application/json")
                    check(status == 200 and ct == "audio/wav" and len(raw) > 44,
                          f"audio: {path} {model} answered {status} {ct}")
                    n = (read_wav(raw)[0].size if not path.endswith("stream")
                         else (len(raw) - 44) // 2)
                    speech[f"{model} {path}"] = dict(wall_s=wall, samples=n)
            out["speech"] = speech
            out["vits"] = _vits_witness(manager.get("vits").engine)
            tcfg = manager.get("tts-base").engine.cfg
            mel = torch.randn((tcfg.max_frames, tcfg.n_mels), device="cuda") - 4.0
            out["tts_base_griffin_lim_ms"] = cuda_time_ms(lambda: T.mel_to_audio(tcfg, mel),
                                                          reps=3)
            x = speech16[: 10 * 16_000]
            status, _ct, raw, wall = _post_raw(base, "/v1/vad", json.dumps(
                {"model": "vad", "audio": x.tolist(), "sample_rate": 16_000}).encode(),
                "application/json")
            segs = json.loads(raw).get("segments") if status == 200 else None
            check(bool(segs), f"audio: /v1/vad answered {status} with {segs}")
            out["vad"] = dict(segments=len(segs), wall_s=wall)
            out["vad_stream"] = _vad_stream_bench()
            log(f"[audio vad_stream] {json.dumps(out['vad_stream'])}")
            out["realtime"] = _realtime_round_trip(base, server.realtime)
        finally:
            server.shutdown()
            manager.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["summary"] = {k: out[k] for k in ("whisper_write_s", "whisper_load_s",
                                          "tts_base_griffin_lim_ms")}
    out["summary"].update(
        whisper=_compact(out["whisper"], ("encoder_cosine", "encoder_ms", "decode_ms_per_token",
                                          "ids_equal")),
        vits=_compact(out["vits"], ("ms_per_speech_s", "cosine", "valid_samples")),
        busy=_compact(out["busy"], ("idle_30s_wall_s", "busy_30s_wall_s",
                                    "busy_45s_capture_wall_s", "idle_45s_wall_s")),
        vad_stream=_compact(out["vad_stream"], ("push_ms_median_first", "push_ms_median_last",
                                                "push_ms_max", "recomputes",
                                                "whole_buffer_detect_ms")),
        realtime=_compact(out["realtime"], ("end_of_speech_to_first_audio_ms",
                                            "commit_to_first_audio_ms", "transcription_ms",
                                            "turn_ttft_ms", "tts_ms", "vad_ms_per_append")))
    log(f"[audio summary] {json.dumps(out['summary'])}")
    return out


def diagnose_whisper_busy() -> dict:
    """Where a whisper request's time goes beside streamed chats (not run by
    main(); `python3 -c 'import chip_smoke as cs; cs.diagnose_whisper_busy()'`
    on the card). The audio phase's server with whisper-large-v3 (bf16,
    seed 31) and the 4-layer 1b chat model: (1) the eager encoder on one
    30 s chunk, its aten ops counted by a dispatch mode, timed idle and
    while BUSY_CHATS streamed chats decode (after a warm round): the extra
    wall an op; (2) a 45 s (2-chunk) transcription posted beside the
    chats, its handler thread's stack sampled every 0.25 s: the seconds in
    the capture lock's wait, in eager runs and captures, in
    instantiation, in replays. Prints one JSON line."""
    import yaml
    from torch.utils._python_dispatch import TorchDispatchMode

    from localai_tpu_torch.audio.wav import write_wav
    from localai_tpu_torch.models import whisper as W

    class _Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            _Ops.n += 1
            return func(*args, **(kwargs or {}))

    root = tempfile.mkdtemp(prefix="whisper-busy-")
    out: dict = {}
    try:
        wcfg = dataclasses.replace(W.WHISPER_PRESETS["whisper-large-v3"], dtype="bfloat16")
        W.save_hf_whisper(wcfg, W.init_params(wcfg, seed=31, device="cuda"),
                          f"{root}/whisper-large-v3-bf16", dtype=torch.bfloat16)
        torch.cuda.empty_cache()
        for d in [{"name": "whisper", "backend": "whisper", "model": "whisper-large-v3-bf16"},
                  dict(LORA_BASE_YAML, name="chat", max_tokens=REALTIME_NEW)]:
            with open(f"{root}/{d['name']}.yaml", "w") as f:
                yaml.safe_dump(d, f)
        manager, server, base = _start_server(root, audio=True)
        try:
            weng = manager.get("whisper").engine
            manager.get("chat")
            speech = _formant_speech(BUSY_SPEECH_S, 75)
            mel = weng.mels(speech[: 30 * 16_000])[:1]

            def encode_ms() -> float:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                with torch.no_grad():
                    W.encode(wcfg, weng.params, mel)
                torch.cuda.synchronize()
                return (time.monotonic() - t0) * 1e3

            encode_ms()
            with _Ops():
                encode_ms()
            idle = statistics.median(encode_ms() for _ in range(3))
            stamps: list = [[] for _ in range(BUSY_CHATS)]

            def chat(i: int, n: int) -> None:
                req = {"model": "chat", "max_tokens": n, "ignore_eos": True, "stream": True,
                       "temperature": 0.0,
                       "messages": [{"role": "user", "content": _obs_text(60, 900 + i)}]}
                _http(base, "/v1/chat/completions", req, time.monotonic(), stamps[i])

            for n in (64, BUSY_CHAT_NEW):
                stamps[:] = [[] for _ in range(BUSY_CHATS)]
                threads = [threading.Thread(target=chat, args=(i, n), daemon=True)
                           for i in range(BUSY_CHATS)]
                for th in threads:
                    th.start()
                if n == 64:
                    for th in threads:
                        th.join(timeout=300)
            while min(len(x) for x in stamps) < 2:
                time.sleep(0.005)
            busy = statistics.median(encode_ms() for _ in range(3))
            samples: dict = {}
            done = threading.Event()

            def where(frames) -> str | None:
                names = [(os.path.basename(f.filename), f.name) for f in frames]
                if not any(n == "transcribe_greedy" for _f, n in names):
                    return None
                if any(n == "_capture_stream" for _f, n in names) or \
                        names[-1][1] == "capture_graph":
                    return "capture lock"
                if any(n == "capture_end" for _f, n in names):
                    return "instantiate"
                if any(n == "capture_graph" for _f, n in names):
                    return "eager run and capture"
                return "replays and the rest"

            def sampler() -> None:
                import traceback

                while not done.is_set():
                    time.sleep(0.25)
                    for fr in sys._current_frames().values():
                        k = where(traceback.extract_stack(fr))
                        if k:
                            samples[k] = samples.get(k, 0) + 0.25

            threading.Thread(target=sampler, daemon=True).start()
            body, ctype = _multipart({"file": ("s.wav", write_wav(speech, 16_000)),
                                      "model": (None, b"whisper")})
            status, _ct, _raw, wall = _post_raw(base, "/v1/audio/transcriptions", body, ctype)
            done.set()
            check(status == 200, f"diagnose_whisper_busy: the transcription answered {status}")
            for th in threads:
                th.join(timeout=600)
            out = dict(encoder_aten_ops=_Ops.n, encoder_idle_ms=idle, encoder_busy_ms=busy,
                       busy_extra_ms_an_op=(busy - idle) / _Ops.n, transcription_45s_wall_s=wall,
                       sampled_s=samples, chats=BUSY_CHATS, chat_tokens=BUSY_CHAT_NEW)
        finally:
            server.shutdown()
            manager.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[diagnose_whisper_busy] {json.dumps(out)}")
    return out


# --------------------------------------------------------------------------- #
# 30. image
# --------------------------------------------------------------------------- #

IMAGE_PROMPT = "a watercolor painting of a lighthouse at dawn, highly detailed"
# SDXL base at its published widths with depth cut for the run's time: the
# UNet's third level 2 transformer blocks deep (of 10), text encoder 2 at
# 8 of its 32 layers.
SDXL_TX_DEPTH = (1, 2, 2)
SDXL_TEXT2_LAYERS = 8


def _image_server(root: str):
    """The port's server over `root` in a thread: the OpenAI and image layers."""
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server
    from localai_tpu_torch.server.image_api import ImageApi

    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=root,
                            generated_content_dir=os.path.join(root, "generated"))
    manager = ModelManager(app, device="cuda")
    router = Router()
    oai = OpenAIApi(manager)
    oai.register(router)
    ImageApi(manager, oai, app.generated_content_dir).register(router)
    server = create_server(app, router)
    threading.Thread(target=server.serve_forever, daemon=True, name="http").start()
    return manager, server, f"http://127.0.0.1:{server.server_address[1]}"


def _alias_sd(src: str, dst: str, sample_size: int) -> None:
    """A checkpoint dir sharing src's weight files (symlinks) whose UNet
    config names another native size."""
    os.makedirs(os.path.join(dst, "unet"))
    for name in os.listdir(src):
        if name != "unet":
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    for name in os.listdir(os.path.join(src, "unet")):
        if name != "config.json":
            os.symlink(os.path.join(src, "unet", name), os.path.join(dst, "unet", name))
    with open(os.path.join(src, "unet", "config.json")) as f:
        doc = json.load(f)
    with open(os.path.join(dst, "unet", "config.json"), "w") as f:
        json.dump(dict(doc, sample_size=sample_size), f)


def _png(base: str, entry: dict) -> bytes:
    import base64

    if "b64_json" in entry:
        return base64.b64decode(entry["b64_json"])
    status, _h, body = _http_call(base, "GET", entry["url"])
    check(status == 200, f"GET {entry['url']}: {status}")
    return body if isinstance(body, bytes) else body.encode("latin-1")


def _post_image(base: str, path: str, payload: dict) -> tuple[list[bytes], float]:
    """(PNG bytes of each image, wall s) of one image request, which must answer 200."""
    import urllib.request

    t0 = time.monotonic()
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        check(r.status == 200, f"{path}: {r.status}")
        body = json.loads(r.read())
    wall = time.monotonic() - t0
    pngs = []
    for entry in body["data"]:
        if "url" in entry:
            with urllib.request.urlopen(base + entry["url"], timeout=60) as r:
                check(r.headers.get("Content-Type") == "image/png", "generated image type")
                pngs.append(r.read())
        else:
            pngs.append(_png(base, entry))
    return pngs, wall


def _check_png(png: bytes, size: int) -> np.ndarray:
    from localai_tpu_torch.server.images import decode_png

    px = decode_png(png)
    check(px.shape == (size, size, 3), f"image shape {px.shape}")
    check(float(px.std()) > 1.0, "image is flat")
    return px


def _sd_witness(eng, ckpt: str) -> dict:
    """SD-1.5 in bf16 (the served engine's weights) against the same
    checkpoint in f32 on the card (cuDNN's TF32 off): one UNet forward at
    the 512² CFG batch (cosine of the noise prediction), one 4-step DDIM
    generate on the same noise (max and mean |Δ| of the [0, 1] image), with
    the bf16 UNet step and VAE decode timed by CUDA events."""
    from localai_tpu_torch.models import latent_diffusion as LD

    cfg, p16 = eng.cfg, eng.params
    _c, p32, _t = LD.load_pipeline(ckpt, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    t = torch.full((2,), 501.0, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            e16 = LD.unet_forward(cfg.unet, p16["unet"], x, t, ctx).float()
            e32 = LD.unet_forward(cfg.unet, p32["unet"], x, t, ctx)
            cos = _cosine(e16.reshape(-1).cpu().numpy(), e32.reshape(-1).cpu().numpy())
            cond, unc = eng._ids(IMAGE_PROMPT, 1), eng._ids("", 1)
            z = torch.randn((1, 4, 64, 64), generator=gen, device="cuda")
            i16 = LD.generate(cfg, p16, cond, unc, steps=4, init_noise=z)
            i32 = LD.generate(cfg, p32, cond, unc, steps=4, init_noise=z)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del p32
    torch.cuda.empty_cache()
    d = (i16 - i32).abs()
    out = dict(unet_cosine=cos, unet_max_abs=float(e32.abs().max()),
               image_max_abs_diff=float(d.max()), image_mean_abs_diff=float(d.mean()),
               finite=bool(torch.isfinite(i16).all() and torch.isfinite(e16).all()))
    with torch.no_grad():
        out["unet_step_ms"] = cuda_time_ms(
            lambda: LD.unet_forward(cfg.unet, p16["unet"], x, t, ctx), reps=5, warmup=1)
        lat = torch.randn((1, 4, 64, 64), generator=gen, device="cuda")
        out["vae_decode_ms"] = cuda_time_ms(lambda: LD.vae_decode(cfg.vae, p16["vae"], lat),
                                            reps=3, warmup=1)
    log(f"[image witness] {json.dumps(out)}")
    check(out["finite"], "SD-1.5 bf16 gave non-finite values")
    check(cos >= 0.99, f"SD-1.5 bf16 UNet against f32: cosine {cos}")
    check(out["image_mean_abs_diff"] <= 0.02 and out["image_max_abs_diff"] <= 0.25,
          f"SD-1.5 bf16 4-step image against f32: {out}")
    return out


def _flux_full(tok_dir: str) -> dict:
    """Flux.1-dev at its published widths and depth (19 double, 38 single
    blocks, T5-XXL, CLIP-L, the 16-channel VAE), bf16 weights drawn on the
    card from a seed (no 24 GB checkpoint), handed to FluxEngine with the
    loader checkpoint's tokenizers: one 1024² image in 4 steps, and one
    transformer step at 1024² timed by CUDA events."""
    from localai_tpu_torch.engine.image_engine import FluxEngine
    from localai_tpu_torch.models import flux as FX
    from localai_tpu_torch.models.latent_diffusion import load_tokenizer_dir

    cfg = FX.FluxPipelineConfig()
    t0 = time.monotonic()
    params = FX.init_params(cfg, seed=49, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    out = dict(draw_s=time.monotonic() - t0,
               params=sum(t.numel() for part in params.values() for t in part.values()))
    toks = (load_tokenizer_dir(os.path.join(tok_dir, "tokenizer")),
            load_tokenizer_dir(os.path.join(tok_dir, "tokenizer_2")))
    eng = FluxEngine(cfg, params, toks)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    imgs = eng.generate(IMAGE_PROMPT, n=1, steps=4, seed=3)
    out["wall_1024_4_steps_s"] = time.monotonic() - t0
    check(imgs[0].shape == (1024, 1024, 3) and float(imgs[0].std()) > 1.0, "Flux image")
    again = eng.generate(IMAGE_PROMPT, n=1, steps=4, seed=3)
    out["seed_repeats_bytes"] = bool(np.array_equal(imgs[0], again[0]))
    check(out["seed_repeats_bytes"], "Flux: a repeated seed gave other bytes")
    gen = torch.Generator(device="cuda").manual_seed(2)
    tcfg = cfg.transformer
    tok = torch.randn((1, 4096, tcfg.in_channels), generator=gen, device="cuda")
    txt = torch.randn((1, 512, tcfg.joint_attention_dim), generator=gen, device="cuda")
    pooled = torch.randn((1, tcfg.pooled_projection_dim), generator=gen, device="cuda")
    ids = torch.from_numpy(FX.image_ids(128, 128)).cuda()
    with torch.no_grad():
        v = FX.flux_forward(tcfg, params["transformer"], tok, txt, pooled,
                            torch.tensor([0.7], device="cuda"), ids,
                            guidance=torch.tensor([3.5], device="cuda"))
        check(bool(torch.isfinite(v).all()), "Flux forward non-finite")
        out["step_ms"] = cuda_time_ms(lambda: FX.flux_forward(
            tcfg, params["transformer"], tok, txt, pooled, torch.tensor([0.7], device="cuda"),
            ids, guidance=torch.tensor([3.5], device="cuda")), reps=3, warmup=1)
    eng.drop_device_state()
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[image flux] {json.dumps(out)}")
    return out


def _dit_card_vs_cpu() -> dict:
    """dit-test in f32: the same seeded tree and noise through generate on
    the card and on the CPU (the port's own plain path)."""
    from localai_tpu_torch.models import diffusion as D

    cfg = D.DIFFUSION_PRESETS["dit-test"]
    cpu = D.init_params(cfg, seed=0, device="cpu")
    cpu["out_w"] = torch.randn(cpu["out_w"].shape, generator=torch.Generator().manual_seed(1)) * 0.05
    card = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict) else v.cuda())
            for k, v in cpu.items()}
    ids = torch.zeros((2, cfg.text_ctx), dtype=torch.long)
    ids[:, :5] = torch.tensor(list(b"a cat"))
    noise = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(2))
    a = D.generate(cfg, cpu, ids, steps=10, noise=noise)
    b = D.generate(cfg, card, ids.cuda(), steps=10, noise=noise.cuda()).cpu()
    out = dict(max_abs_diff=float((a - b).abs().max()), tol=1e-3)  # the CPU tests' image tol
    check(out["max_abs_diff"] <= out["tol"], f"dit-test card against CPU: {out}")
    return out


def phase_image(smi: str) -> dict:
    """Image and video generation through the port's server on the card:
    SD-1.5 at full width and depth (a bf16 diffusers checkpoint of seeded
    random weights, save_diffusers) over /v1/images/generations (512², 20
    DDIM steps, n 1 and 4, b64_json and url; a repeated seed gives the same
    bytes), /v1/images/inpainting (multipart) and img2img, held to its f32
    witness (_sd_witness); SDXL base (published widths, depth cut: SDXL_TX_DEPTH,
    SDXL_TEXT2_LAYERS) at 1024² in 4 steps; Flux's loader on a 1-block
    checkpoint at Flux.1-dev's widths, then Flux.1-dev at full width and depth
    from weights drawn on the card (_flux_full); AnimateDiff (a motion
    adapter at v1-5-2's widths over the SD-1.5 weights at a 256² native
    size) over /v1/videos, 8 frames; the dit-test preset over the server and
    card against CPU. No B1-B5 kernel runs on this path: the launch counters
    stay 0."""
    import yaml

    from localai_tpu_torch.models import flux as FX
    from localai_tpu_torch.models import latent_diffusion as LD
    from localai_tpu_torch.models import video_diffusion as VD

    root = tempfile.mkdtemp(prefix="image-")
    out: dict = {"card": smi}
    try:
        t0 = time.monotonic()
        LD.save_diffusers(LD.sd15_config(), f"{root}/sd15", seed=41, dtype=torch.bfloat16,
                          device="cuda")
        out["sd15_write_s"] = time.monotonic() - t0
        xl = LD.sdxl_config()
        xl.unet.transformer_layers_per_block = SDXL_TX_DEPTH
        xl.text2.num_hidden_layers = SDXL_TEXT2_LAYERS
        LD.save_diffusers(xl, f"{root}/sdxl", seed=43, dtype=torch.bfloat16, device="cuda")
        _alias_sd(f"{root}/sd15", f"{root}/anim", sample_size=32)
        VD.save_motion_adapter(VD.MotionConfig(), f"{root}/anim/motion_adapter", seed=45,
                               dtype=torch.bfloat16, device="cuda")
        fcfg = FX.FluxPipelineConfig()
        fcfg.transformer.num_layers = fcfg.transformer.num_single_layers = 1
        fcfg.t5.num_layers = fcfg.clip.num_hidden_layers = 1
        FX.save_flux(fcfg, f"{root}/flux-1l", seed=47, dtype=torch.bfloat16, device="cuda")
        out["write_s"] = time.monotonic() - t0
        for doc in ({"name": "sd15", "backend": "diffusers", "model": "sd15"},
                    {"name": "sdxl", "backend": "diffusers", "model": "sdxl"},
                    {"name": "anim", "backend": "diffusers", "model": "anim"},
                    {"name": "flux-1l", "backend": "diffusers", "model": "flux-1l"},
                    {"name": "dit", "backend": "diffusion", "model": "dit-test"}):
            with open(f"{root}/{doc['name']}.yaml", "w") as f:
                yaml.safe_dump(doc, f)
        manager, server, base = _image_server(root)
        try:
            _zero_counts()
            t0 = time.monotonic()
            eng = manager.get("sd15").engine
            out["sd15_load_s"] = time.monotonic() - t0
            check(next(iter(eng.params["unet"].values())).dtype == torch.bfloat16,
                  "SD-1.5 should load in its stored bf16")
            body = {"model": "sd15", "prompt": IMAGE_PROMPT, "size": "512x512", "steps": 20,
                    "guidance_scale": 7.5, "seed": 7}
            (first,), out["wall_n1_first_s"] = _post_image(
                base, "/v1/images/generations", {**body, "response_format": "b64_json"})
            (second,), out["wall_n1_s"] = _post_image(base, "/v1/images/generations", body)
            check(first == second, "SD-1.5: a repeated seed gave other bytes")
            src = _check_png(first, 512)
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            four, out["wall_n4_s"] = _post_image(base, "/v1/images/generations",
                                                 {**body, "n": 4, "seed": 8,
                                                  "response_format": "b64_json"})
            out["peak_extra_bytes_n4"] = torch.cuda.max_memory_allocated() - base_mem
            px = [_check_png(p, 512) for p in four]
            check(len(px) == 4 and not np.array_equal(px[0], px[1]), "n=4 images")
            from localai_tpu_torch.server.images import encode_png

            mask = np.zeros((512, 512), np.uint8)
            mask[128:384, 128:384] = 255
            raw, ctype = _multipart({"model": (None, b"sd15"), "prompt": (None, IMAGE_PROMPT.encode()),
                                     "steps": (None, b"20"), "seed": (None, b"4"),
                                     "image": ("image.png", first),
                                     "mask": ("mask.png", encode_png(mask)),
                                     "response_format": (None, b"b64_json")})
            status, rtype, data, out["inpaint_wall_s"] = _post_raw(
                base, "/v1/images/inpainting", raw, ctype)
            check(status == 200, f"inpainting: {status} {data[:200]!r}")
            _check_png(_png(base, json.loads(data)["data"][0]), 512)
            import base64

            (i2i,), out["img2img_wall_s"] = _post_image(base, "/v1/images/generations", {
                **body, "image": base64.b64encode(first).decode(), "strength": 0.5,
                "response_format": "b64_json"})
            _check_png(i2i, 512)
            out["witness"] = _sd_witness(eng, f"{root}/sd15")
            manager.unload("sd15", drain_s=0.0)
            del eng
            t0 = time.monotonic()
            manager.get("sdxl")
            out["sdxl_load_s"] = time.monotonic() - t0
            (xl_png,), out["sdxl_wall_1024_4_steps_s"] = _post_image(
                base, "/v1/images/generations", {"model": "sdxl", "prompt": IMAGE_PROMPT,
                                                 "steps": 4, "seed": 9,
                                                 "response_format": "b64_json"})
            _check_png(xl_png, 1024)
            manager.unload("sdxl", drain_s=0.0)
            (fl_png,), out["flux_1l_wall_512_2_steps_s"] = _post_image(
                base, "/v1/images/generations", {"model": "flux-1l", "prompt": IMAGE_PROMPT,
                                                 "size": "512x512", "steps": 2, "seed": 3,
                                                 "response_format": "b64_json"})
            _check_png(fl_png, 512)
            manager.unload("flux-1l", drain_s=0.0)
            gc.collect()
            torch.cuda.empty_cache()
            out["flux"] = _flux_full(f"{root}/flux-1l")
            t0 = time.monotonic()
            status, _h, vid = _http_call(base, "POST", "/v1/videos", {
                "model": "anim", "prompt": IMAGE_PROMPT, "n_frames": 8, "steps": 10,
                "seed": 3})
            out["video_wall_s"] = time.monotonic() - t0
            check(status == 200, f"/v1/videos: {status} {vid}")
            import urllib.request

            with urllib.request.urlopen(base + vid["data"][0]["url"], timeout=60) as r:
                ctype, blob = r.headers.get("Content-Type", ""), r.read()
            check(ctype in ("image/gif", "video/mp4") and len(blob) > 0, f"video {ctype}")
            check(ctype != "image/gif" or blob[:6] == b"GIF89a", "video: not a GIF")
            out["video_type"], out["video_bytes"] = ctype, len(blob)
            motion = manager.get("anim").engine.motion
            check(motion is not None, "anim: no motion adapter loaded")
            (dit_png,), _w = _post_image(base, "/v1/images/generations", {
                "model": "dit", "prompt": "a cat", "steps": 10, "response_format": "b64_json"})
            _check_png(dit_png, 16)
            out["dit_card_vs_cpu"] = _dit_card_vs_cpu()
            out["launches"] = _read_counts()
            check(not any(out["launches"].values()),
                  f"the image path launched a B1-B5 kernel: {out['launches']}")
        finally:
            server.shutdown()
            manager.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    w = out["witness"]
    out["summary"] = dict(
        card=smi, sd15_load_s=out["sd15_load_s"], unet_step_ms=w["unet_step_ms"],
        wall_512_20_steps_n1_s=out["wall_n1_s"], wall_512_20_steps_n4_s=out["wall_n4_s"],
        vae_decode_ms=w["vae_decode_ms"], peak_extra_bytes_n4=out["peak_extra_bytes_n4"],
        flux_step_ms=out["flux"]["step_ms"], video_wall_s=out["video_wall_s"],
        unet_cosine=w["unet_cosine"], image_max_abs_diff=w["image_max_abs_diff"])
    log(f"[image] {json.dumps({k: v for k, v in out.items() if k != 'summary'})}")
    log(f"[image summary] {json.dumps(out['summary'])}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    t_start = time.monotonic()
    seconds = {}

    def timed(label, fn, *args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        seconds[label] = round(time.monotonic() - t0, 1)
        log(f"[phase {label}] {seconds[label]}s")
        # Also on stderr, whose tail a run stopped at its time limit keeps.
        print(f"[phase {label}] {seconds[label]}s, {time.monotonic() - t_start:.1f}s in all",
              file=sys.stderr, flush=True)
        return out

    name, smi = timed("device", phase_device)
    _arch_1b()  # registers ONEB_PRESET, which the server's YAMLs name
    usage = timed("build", phase_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = timed("flash_kernels", phase_kernels, gen)
    paged_rows = timed("paged_kernels", phase_paged_kernels, gen)
    b3_rows, b4_rows = timed("quant_kernels", phase_quant_kernels, gen)
    model = timed("model", phase_model, gen)
    dense = timed("engine", phase_engine, model["cfg"], model["params"])
    paged = timed("paged_engine", phase_paged_engine, model["cfg"], model["params"],
                  model["small"], model["p_small"])
    graphs_1b = timed("graphs_1b", phase_graphs, f"llama-3.2-1b paged, {ONEB_LAYERS} layers",
                      model["cfg"], model["params"])
    del model["params"]
    torch.cuda.empty_cache()
    long_context = timed("long_context", phase_long_context)
    prefix = timed("prefix_swap", phase_prefix_swap, model["small"], model["p_small"])
    grammar = timed("grammar", phase_grammar)
    tree = timed("tree", phase_tree, model["small"], model["p_small"])
    observe = timed("observe", phase_observe)
    embed_rerank = timed("embed_rerank", phase_embed_rerank)
    vision = timed("vision", phase_vision)
    service = timed("service", phase_service)
    qmodel = timed("quant_model", phase_quant_model, gen)
    qruns = timed("quant_engines", phase_quant_engines, qmodel, model["small"],
                  model["p_small"], model["p_small_cpu"])
    graphs_8b = timed("graphs_8b", phase_graphs,
                      f"llama-3-8b int4 + fp8 paged, {QUANT_ENGINE_LAYERS} layers",
                      *_first_layers(qmodel["cfg"], qmodel["int4"], QUANT_ENGINE_LAYERS),
                      kv_cache_dtype="fp8", kv_scale=2.0)
    prefix_8b = timed("prefix_swap_8b", phase_prefix_8b, qmodel)
    lora_rows, lora_groups = timed("lora_kernels", phase_lora_kernels, gen)
    lora_http = timed("lora_http", phase_lora_http)
    lora_8b = timed("lora_8b", phase_lora_8b, qmodel, model["small"], model["p_small"],
                    model["p_small_cpu"])
    spec = timed("spec", phase_spec, qmodel, model["small"], model["p_small"],
                 model["p_small_cpu"])
    del qmodel, model
    gc.collect()
    torch.cuda.empty_cache()  # mixtral's 35 GB of int4 weights come next
    moe_rows = timed("moe_kernels", phase_moe_kernels)
    mixtral = timed("mixtral", phase_mixtral, gen)
    mixtral_int8 = timed("mixtral_int8", phase_mixtral_int8)
    moe_small = timed("moe_small", phase_moe_small)
    gc.collect()
    torch.cuda.empty_cache()
    latent_rows = timed("latent_kernels", phase_latent_kernels)
    deepseek = timed("deepseek", phase_deepseek, latent_rows)
    deepseek_http = timed("deepseek_http", phase_deepseek_http)
    deepseek_int4 = timed("deepseek_int4", phase_deepseek_int4)
    deepseek_small = timed("deepseek_small", phase_deepseek_small)
    gc.collect()
    torch.cuda.empty_cache()
    gguf = timed("gguf", phase_gguf, gen)
    gguf_deepseek = timed("gguf_deepseek", phase_gguf_deepseek)
    expert_lora = timed("expert_lora", phase_expert_lora)
    audio = timed("audio", phase_audio)
    image = timed("image", phase_image, smi)
    runs = {"dense_engine": dense, "paged_engine": paged, **qruns, "lora_8b_int8": lora_8b,
            "graphs_1b": graphs_1b["graph"], "graphs_1b_eager": graphs_1b["eager"],
            "graphs_8b": graphs_8b["graph"], "graphs_8b_eager": graphs_8b["eager"],
            "mixtral_int4": mixtral["graph"], "mixtral_int4_eager": mixtral["eager"],
            "mixtral_int8_8_layers": mixtral_int8,
            "long_context_flat": long_context["flat"],
            "long_context_hier_spill": long_context["hier_spill"],
            "prefix_chat_hit": prefix["chat_hit_run"], "prefix_chat_miss": prefix["chat_miss_run"],
            "prefix_swap_pressured": prefix["swap_runs"]["pressured"],
            "prefix_swap_recompute": prefix["swap_runs"]["recompute"],
            "prefix_swap_ample": prefix["swap_runs"]["ample"],
            "prefix_8b_hit": {"launches": prefix_8b["launches"]["hit"]},
            "prefix_8b_miss": {"launches": prefix_8b["launches"]["miss"]},
            **grammar["runs"], **tree["runs"], **spec["runs"],
            **{f"spec_small_{k}": v for k, v in spec["small"].items()},
            "gguf_http_llama_3_2_1b": gguf["http"],
            "gguf_engine_llama_3_2_1b": gguf["engine_llama-3.2-1b"],
            "gguf_engine_llama_3_8b": gguf["engine_llama-3-8b"],
            "deepseek_v2_lite": deepseek["graph"], "deepseek_v2_lite_eager": deepseek["eager"],
            "deepseek_v2_lite_prefix_hit": deepseek["graph"]["follow"],
            "deepseek_v2_lite_dense": deepseek["dense"],
            "deepseek_v2_lite_int4_8_layers": deepseek_int4,
            "observe_1b": observe["traces"]["run"], **embed_rerank["runs"], **vision["runs"],
            # The parent's in-process models of the service phase; its
            # subprocess child's launches happen in the child, not counted here.
            "service_parent": service["run"],
            "gguf_deepseek_engine": gguf_deepseek["engine"],
            "gguf_deepseek_http": gguf_deepseek["http"],
            "expert_lora_mixtral_int4": expert_lora,
            # The realtime turn's launches (whisper and the voices run no kernel).
            "audio_realtime": audio["realtime"],
            # SD-1.5, SDXL, Flux, AnimateDiff and the DiT: no B1-B5 kernel (all 0).
            "image": image}
    by_path = {k: {path: out["launches"].get(k, 0) for path, out in runs.items()}
               for k in ("flash_prefill", "paged_attention", "paged_attention_latent",
                         "quant_matmul", "quant_matmul_moe", "quant_unembed", "lora_bgmv",
                         "quant_matmul_q", "quant_matmul_gq", "quant_matmul_g4")}
    by_path["lora_bgmv"]["lora_http"] = lora_http["tenants"]["lora_bgmv_launches"]
    # The main shape of B1: llama-3.2-1b's 8 x 2048 admission with every row
    # at full length, so the kernel, SDPA and the bound count the same work.
    main_row = next(r for r in rows if r["shape"] == [8, 2048, 32, 8, 64]
                    and r["dtype"] == "bfloat16" and r["library_same_work"])
    ragged_row = next(r for r in rows if r["shape"] == [8, 2048, 32, 8, 64]
                      and r["dtype"] == "bfloat16" and not r["library_same_work"])
    flash_record = {
        "name": "flash_prefill",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "localai_tpu/ops/flash.py:41",
        "tpu_kernel": "localai_tpu/ops/flash.py::_flash_kernel",
        "launches": sum(by_path["flash_prefill"].values()),
        "launches_by_path": by_path["flash_prefill"],
        "shape": main_row["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        "tol": main_row["tol"],
        "ok": all(r["ok"] for r in rows),
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_same_work": main_row["library_same_work"],
        # The same shape with the engine's ragged lengths (SDPA not comparable).
        "ragged": _compact(ragged_row, ("shape", "lengths", "ms", "plain_ms", "bound_ms")),
        # Embeddings and rerank through the server: the forward at a bucket
        # (B1 on every layer), the f32 witnesses, bert and the store.
        "embed_rerank": {k: v for k, v in embed_rerank.items() if k != "runs"},
        # The realtime turn's admissions: the 4-layer 1b's prompt after whisper.
        "audio": audio["summary"],
        # Vision chat: Qwen2-VL-2B's image admissions (H 12, K 2, D 128) with
        # the image injected and m-rope, llava's into llama-3-8b.
        "vision": {"rows": [_compact(r, ("shape", "lengths", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", "max_abs_err"))
                            for r in rows if r["shape"][2:4] == [12, 2]],
                   "qwen2_vl_2b": vision["qwen2_vl"]["summary"],
                   "llava_8b": vision["llava"]["summary"], "tiny": vision["tiny"]},
        "shapes": rows,
    }
    # The main shape of B2: llama-3.2-1b paged decode, 8 slots, D = 64; its
    # long-context forms are the rows with a "form".
    paged_main = paged_rows[0]
    long_rows = [r for r in paged_rows if "form" in r]
    paged_record = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/paged_attention.cu",
        "replaces": "localai_tpu/ops/paged_flash.py:78",
        "tpu_kernel": "localai_tpu/ops/paged_flash.py::_ragged_paged_kernel",
        "launches": sum(by_path["paged_attention"].values()),
        "launches_by_path": by_path["paged_attention"],
        "shape": {k: paged_main[k] for k in ("shape", "B", "H", "K", "QR", "D", "page", "MP")},
        "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
        "tol": paged_main["tol"],
        "ok": all(r["ok"] for r in paged_rows),
        "ms": paged_main["ms"],
        "kernel_ms": paged_main["ms"],
        "plain_ms": paged_main["plain_ms"],
        "bound_ms": paged_main["bound_ms"],
        "bound_by": paged_main["bound_by"],
        "library_ms": None,  # no one PyTorch call computes partials over a page table
        "bound_basis": paged_main["bound_basis"],
        "repeat_equal": all(r["repeat_equal"] for r in paged_rows),
        "alone_equal": all(r["alone_equal"] for r in paged_rows),
        # ptxas: registers, spill bytes, static shared memory of each instance.
        "ptxas": [r for r in usage["paged_attention"] if "paged_" in r["kernel"]],
        # The hierarchical (l1, l0) tables and the sink + window skip: each
        # form's times against its bound, its plain version and the same
        # slots walked in full, and the 130k-token engine runs.
        "long_context": {
            "forms": [_compact(r, ("shape", "form", "B", "QR", "MP", "span", "sink", "swin",
                                   "visited_rows", "ms", "plain_ms", "full_walk_ms",
                                   "bound_ms", "bound_by", "library_ms", "max_abs_err",
                                   "hier_equal_flat", "spilled_equal_hot"))
                      for r in long_rows],
            "hier_equal_flat": all(r["hier_equal_flat"] for r in long_rows),
            "spilled_equal_hot": all(r["spilled_equal_hot"] for r in long_rows),
            "engine": long_context["summary"],
        },
        # Prefix hits walk shared pages from the match, swaps restore pages.
        "prefix_swap": {"chat": prefix["chat"], "swap": prefix["swap"], "long": prefix["long"],
                        "tiny": prefix["tiny"], "llama_3_8b_int4_fp8": prefix_8b},
        # Constrained admissions (B1, or B2 chunks) and DFA / host-walk decode
        # blocks on the paged pool.
        "grammar": grammar["summary"],
        # Fork branches decode over their primary's shared pages; logprob
        # blocks (the top-20 epilogue in the graph).
        "tree": tree["summary"],
        # Speculative rounds: the verify chunk's T·G query rows a kv head
        # through the multi-query form (rows "verify_t3" / "verify_t6").
        "spec": spec["summary"],
        # Qwen2-VL-2B's decode blocks (G = 6 at D = 128) with image and text
        # slots, each at its own rope delta.
        "vision": _compact(next(r for r in paged_rows if r["shape"] == "decode_g6_qwen2vl"),
                           ("shape", "B", "H", "K", "D", "ms", "plain_ms", "bound_ms",
                            "bound_by", "max_abs_err", "plan")),
        "shapes": paged_rows,
    }
    # The main shape of B3: llama-3-8b's w_gate at a decode block of 8 slots,
    # int4 weights, bf16 x.
    b3_main = next(r for r in b3_rows if r["shape"] == [8, 4096, 14336]
                   and r["form"] == "int4" and r["dtype"] == "bfloat16")
    quant_record = {
        "name": "quant_matmul",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "localai_tpu/ops/quant_matmul.py:109",
        "tpu_kernel": "localai_tpu/ops/quant_matmul.py::_qmm_kernel",
        "launches": sum(by_path["quant_matmul"].values()),
        "launches_by_path": by_path["quant_matmul"],
        # B3's 2-D launches by weight form over every path: flat int8 (the
        # port's own int8), grouped int8 (GGUF q8_0 and the regridded types),
        # packed int4 (the port's int4, GGUF q4_0 / q4_K).
        "launches_by_form": {f: sum(by_path[f"quant_matmul_{f}"].values())
                             for f in ("q", "gq", "g4")},
        "shape": {"N": 8, "in": 4096, "out": 14336, "form": "int4", "dtype": "bfloat16"},
        "max_abs_err": b3_main["max_abs_err"],
        "tol": "f32 x: 1e-4 x max|out|; bf16 x: 2^-7 x |out| + 1e-4 x max|out|",
        "ok": all(r["ok"] for r in b3_rows),
        "ms": b3_main["ms"],
        "kernel_ms": b3_main["ms"],
        "plain_ms": b3_main["plain_ms"],
        "bound_ms": b3_main["bound_ms"],
        "bound_by": b3_main["bound_by"],
        "bf16_ms": b3_main["bf16_ms"],
        "dequant_ms": b3_main["dequant_ms"],
        "library_ms": None,  # no one PyTorch call takes the packed int8 / int4 layouts
        "repeat_equal": all(r["repeat_equal"] for r in b3_rows),
        "rows_alone_equal": all(r["rows_alone_equal"] is not False for r in b3_rows),
        # ptxas: registers, spill bytes, static shared memory of each instance
        # (the tensor-core instances take their ring as dynamic shared memory).
        "ptxas": [r for r in usage["quant_matmul"] if "qmm" in r["kernel"]],
        # Every shape's full row is in the log above; here the times only.
        "shapes": [_compact(r, ("shape", "form", "dtype", "ms", "bf16_ms", "dequant_ms",
                                "bound_ms"))
                   for r in b3_rows],
        # Layer 0 of the two GGUF files as the loader repacked them (g4 with
        # per-group zero points from q4_K, gq from q8_0 and regridded q6_K),
        # and the served runs.
        "gguf": {"summary": gguf["summary"],
                 "layer_rows": [_compact(r, ("key", "ggml_type", "form", "shape", "ms", "plain_ms",
                                             "bf16_ms", "dequant_ms", "bound_ms", "max_abs_err",
                                             "dequant_route_f32_err"))
                                for r in gguf["b3_rows"]]},
    }
    # The main shape of B3's expert form: mixtral-8x7b's gate at a decode
    # block of 8 slots, int4 experts, bf16 x.
    moe_main = next(r for r in moe_rows if r["shape"] == [8, 8, 4096, 14336]
                    and r["form"] == "int4" and r["dtype"] == "bfloat16")
    moe_record = {
        "name": "quant_matmul_moe",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "localai_tpu/ops/quant_matmul.py:109",
        "tpu_kernel": "localai_tpu/ops/quant_matmul.py::_qmm_kernel (expert grid, "
                      "_plain_moe_mm :281)",
        "kernel": "qmm_mma_kernel<FORM, MT, NT> / qmm_kernel<float, RT, FORM> with the "
                  "expert axis (ops/quant_matmul.qmm_moe)",
        "launches": sum(by_path["quant_matmul_moe"].values()),
        "launches_by_path": {k: v for k, v in by_path["quant_matmul_moe"].items() if v},
        "shape": {"N": 8, "E": 8, "in": 4096, "out": 14336, "form": "int4",
                  "dtype": "bfloat16", "einsum": "...d,edf->...ef"},
        "max_abs_err": moe_main["max_abs_err"],
        "tol": "f32 x: 1e-4 x max|out|; bf16 x: 2^-7 x |out| + 1e-4 x max|out|",
        "ok": all(r["ok"] for r in moe_rows),
        "ms": moe_main["ms"],
        "kernel_ms": moe_main["ms"],
        "plain_ms": moe_main["plain_ms"],
        "bound_ms": moe_main["bound_ms"],
        "bound_by": moe_main["bound_by"],
        "bf16_ms": moe_main["bf16_ms"],
        "dequant_ms": moe_main["dequant_ms"],
        "library_ms": None,  # no one PyTorch call takes the packed int8 / int4 expert stacks
        "repeat_equal": all(r["repeat_equal"] for r in moe_rows),
        "rows_alone_equal": all(r["rows_alone_equal"] is not False for r in moe_rows),
        # The same nine tensor-core and six scalar instances as quant_matmul's
        # record: the expert axis is one more argument, not another instance.
        "ptxas": [r for r in usage["quant_matmul"] if "qmm" in r["kernel"]],
        "mixtral": mixtral["summary"],
        "moe_small": moe_small,
        # LoRA merged into mixtral's experts (1 layer, int4): the merged tree's run.
        "expert_lora": _compact(expert_lora, ("load_s", "payloads_equal", "ids_equal")),
        "shapes": [_compact(r, ("sub", "shape", "form", "dtype", "ms", "bf16_ms", "dequant_ms",
                                "bound_ms"))
                   for r in moe_rows],
    }
    # B3's expert form on grouped int8 stacks (a deepseek2 GGUF's experts):
    # deepseek-v2-lite's gate at a decode block of 8 slots, bf16 x.
    gq_rows = [r for r in moe_rows if r["form"] == "grouped_int8" and r["shape"][1] == 64]
    gq_main = next(r for r in gq_rows if r["shape"] == [8, 64, 2048, 1408])
    gq_paths = ("gguf_deepseek_engine", "gguf_deepseek_http")
    gq_record = {
        "name": "quant_matmul_moe_gq",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "localai_tpu/ops/quant_matmul.py:109",
        "tpu_kernel": "localai_tpu/ops/quant_matmul.py::_qmm_kernel (expert grid, grouped int8)",
        "kernel": "qmm_mma_kernel<FORM_GQ, MT, NT> with the expert axis (ops/quant_matmul.qmm_moe)",
        # Every expert launch of the deepseek2 GGUF's runs (its experts are gq).
        "launches": sum(by_path["quant_matmul_moe"][k] for k in gq_paths),
        "launches_by_path": {k: by_path["quant_matmul_moe"][k] for k in gq_paths},
        "shape": {"N": 8, "E": 64, "in": 2048, "out": 1408, "form": "grouped_int8",
                  "dtype": "bfloat16", "einsum": "...d,edf->...ef"},
        "max_abs_err": max(r["max_abs_err"] for r in gq_rows),
        "tol": "bf16 x: 2^-7 x |out| + 1e-4 x max|out|",
        "ok": all(r["ok"] for r in gq_rows),
        "ms": gq_main["ms"],
        "kernel_ms": gq_main["ms"],
        "plain_ms": gq_main["plain_ms"],
        "bound_ms": gq_main["bound_ms"],
        "bound_by": gq_main["bound_by"],
        "bf16_ms": gq_main["bf16_ms"],
        "dequant_ms": gq_main["dequant_ms"],
        "library_ms": None,  # no one PyTorch call takes grouped int8 expert stacks
        "repeat_equal": all(r["repeat_equal"] for r in gq_rows),
        "gguf_deepseek": gguf_deepseek["summary"],
        "shapes": [_compact(r, ("sub", "shape", "ms", "plain_ms", "bf16_ms", "dequant_ms",
                                "bound_ms", "bound_by", "max_abs_err")) for r in gq_rows],
    }
    b4_main = next(r for r in b4_rows if r["shape"] == [8, 128256, 4096]
                   and r["dtype"] == "bfloat16")
    unembed_record = {
        "name": "quant_unembed",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "localai_tpu/ops/quant_matmul.py:168",
        "tpu_kernel": "localai_tpu/ops/quant_matmul.py::_unembed_kernel",
        "launches": sum(by_path["quant_unembed"].values()),
        "launches_by_path": by_path["quant_unembed"],
        "shape": {"N": 8, "V": 128256, "D": 4096, "dtype": "bfloat16"},
        "max_abs_err": b4_main["max_abs_err"],
        "tol": "1e-4 x max|logit| (f32 on both sides)",
        "ok": all(r["ok"] for r in b4_rows),
        "ms": b4_main["ms"],
        "kernel_ms": b4_main["ms"],
        "plain_ms": b4_main["plain_ms"],
        "bound_ms": b4_main["bound_ms"],
        "bound_by": b4_main["bound_by"],
        "bf16_ms": b4_main["bf16_ms"],
        "bound_frac": b4_main["bound_frac"],
        "library_ms": None,  # no one PyTorch call takes an int8 head with its scales
        # bf16 h: unembed_mma_kernel<NT> by ops/quant_matmul.qunembed_plan;
        # f32 h: the scalar unembed_kernel<RT>.
        "plan": b4_main["plan"],
        "repeat_equal": all(r["repeat_equal"] for r in b4_rows),
        "rows_independent": all(r["rows_alone_equal"] is not False for r in b4_rows),
        # ptxas: registers, spill bytes, static shared memory of each instance
        # (the tensor-core instances take h as dynamic shared memory).
        "ptxas": [r for r in usage["quant_matmul"] if "unembed" in r["kernel"]],
        # The int8 head of the llama-3-8b GGUF's q8_0 output.weight.
        "gguf_head": _compact(gguf["b4_row"], ("shape", "dtype", "ms", "plain_ms", "bf16_ms",
                                                "bound_ms", "max_abs_err",
                                                "dequant_route_f32_err")),
        "shapes": b4_rows,
    }
    # The main shape of B5: llama-3.2-1b's wq (2048 -> 2048) at rank 16 over
    # 8 slots' adapters and a null row, bf16.
    lora_main = next(r for r in lora_rows if r["shape"] == [9, 2048, 2048] and r["rank"] == 16)
    served = lora_http["kernel_rows"]
    lora_record = {
        "name": "lora_bgmv",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/lora_matmul.cu",
        "replaces": "localai_tpu/ops/lora_matmul.py:105",
        "tpu_kernel": "localai_tpu/ops/lora_matmul.py::_lora_kernel",
        # One launch of lora_group_kernel per group of 1-3 targets sharing x
        # (shrink and expand inside it, one thread-block cluster per segment
        # and target); the launches are the grouped calls.
        "kernel": "lora_group_kernel<x, factors> (ops/lora_matmul.lora_bgmv_group)",
        "launches": sum(by_path["lora_bgmv"].values()),
        "launches_by_path": {k: v for k, v in by_path["lora_bgmv"].items() if v},
        "shape": {"N": 9, "in": 2048, "out": 2048, "R": 16, "dtype": "bfloat16"},
        "max_abs_err": max(r["max_abs_err"] for r in lora_rows + lora_groups + served),
        "tol": "bf16: 2^-7 x |out| + 1e-4 x max|out| (f32 on both sides, one bf16 rounding)",
        "ok": all(r["ok"] for r in lora_rows + lora_groups + served),
        "rows_independent": all(r["rows_independent"] for r in lora_rows + lora_groups + served),
        "repeat_equal": all(r["repeat_equal"] for r in lora_rows + lora_groups + served),
        "allocates_outputs_only": all(r["allocates_outputs_only"]
                                      for r in lora_rows + lora_groups + served),
        # lora_http's own stacks (rank 32, 9 rows) at its decode block's ids.
        "served_stacks": {"cases": len(served),
                          "max_abs_err": max(r["max_abs_err"] for r in served)},
        "ms": lora_main["ms"],
        "kernel_ms": lora_main["ms"],
        "plain_ms": lora_main["plain_ms"],
        "bound_ms": lora_main["bound_ms"],
        "bound_by": lora_main["bound_by"],
        # For reference only: torch.bmm twice on factors gathered beforehand
        # (two calls, not one computing the same function).
        "bmm2_gathered_ms": lora_main["bmm2_gathered_ms"],
        # The same flushed timing of a zero_ on 8 floats: the floor under any launch.
        "timing_floor_ms": lora_groups[0]["timing_floor_ms"],
        "library_ms": None,  # no one PyTorch call computes a per-row gathered delta
        # ptxas: registers, spill bytes, static shared memory of each instance.
        "ptxas": [r for r in usage["lora_matmul"] if "lora_group_kernel" in r["kernel"]],
        "shapes": [_compact(r, ("shape", "rank", "padded_rank", "ms", "plain_ms",
                                "bmm2_gathered_ms", "bound_ms", "max_abs_err"))
                   for r in lora_rows],
        "groups": [_compact(r, ("group", "shape", "rank", "ms", "per_target_ms_sum", "plain_ms",
                                "bmm2_gathered_ms", "bound_ms", "max_abs_err"))
                   for r in lora_groups],
    }
    # The main shape of B2's latent form: deepseek-v2-lite's decode, 8 slots,
    # 16 heads on one latent head of 576, bf16 pool.
    latent_main = next(r for r in latent_rows if r["shape"] == "decode"
                       and r["pool_dtype"] == "bfloat16")
    latent_record = {
        "name": "paged_attention_latent",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/paged_attention.cu",
        "replaces": "localai_tpu/ops/paged_flash.py:78",
        "tpu_kernel": "localai_tpu/ops/paged_flash.py::_ragged_paged_kernel, its MLA form (one "
                      "kv head, D = 576, K and V one pool: localai_tpu/models/llama.py:1015)",
        "kernel": "paged_latent_kernel<T> (bf16 / fp8 pools, D = 576); "
                  "paged_scalar_kernel<48, QT> (f32 pools, tiny-mla)",
        "launches": sum(by_path["paged_attention_latent"].values()),
        "launches_by_path": {k: v for k, v in by_path["paged_attention_latent"].items() if v},
        "shape": {k: latent_main[k] for k in ("shape", "B", "H", "K", "QR", "D", "page", "MP")},
        "max_abs_err": max(r["max_abs_err"] for r in latent_rows),
        "tol": latent_main["tol"],
        "ok": all(r["ok"] for r in latent_rows),
        "ms": latent_main["ms"],
        "kernel_ms": latent_main["ms"],
        "plain_ms": latent_main["plain_ms"],
        "bound_ms": latent_main["bound_ms"],
        "bound_by": latent_main["bound_by"],
        "library_ms": None,  # no one PyTorch call computes partials over a page table
        "repeat_equal": all(r["repeat_equal"] for r in latent_rows),
        "alone_equal": all(r["alone_equal"] for r in latent_rows),
        "ptxas": [r for r in usage["paged_attention"] if "paged_latent_kernel" in r["kernel"]
                  or "paged_scalar_kernel<48" in r["kernel"]],
        "deepseek_v2_lite": deepseek["summary"],
        "deepseek_int4_8_layers": _compact(deepseek_int4, (
            "decode_tok_s", "decode_ms_per_step", "ttft_ms_p50", "weight_bytes", "launches")),
        "deepseek_http": deepseek_http,
        "tiny_mla_card_vs_cpu": deepseek_small,
        "shapes": [_compact(r, ("shape", "QR", "D", "pool_dtype", "table", "ms", "plain_ms",
                                "bound_ms", "bound_by", "max_abs_err", "plan"))
                   for r in latent_rows],
    }
    log(f"[phases] {json.dumps(seconds)}")
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": [flash_record, paged_record, latent_record, quant_record,
                                  moe_record, gq_record, unembed_record, lora_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
