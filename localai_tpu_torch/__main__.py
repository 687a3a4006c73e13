"""CLI entry point: `python -m localai_tpu_torch [run|models|transcribe|tts|version]`.

`run` starts the OpenAI-compatible server over the models dir, with the
layers the JAX CLI registers, in its order: audio (`/v1/audio/*`, `/tts`,
`/v1/vad`, `/v1/sound-generation`), image (`/v1/images/generations`,
`/v1/images/inpainting`, `/v1/videos` and the generated files), rerank
(`/v1/rerank`), realtime
(`/v1/realtime` and its session routes), the vector store (`/stores/*`), the model gallery (`/models/available`,
`apply`, `jobs`, `galleries`, `delete`), MCP chat with the agent jobs
(`/mcp/v1/chat/completions`, `/agent-jobs/*`; the jobs' scheduler starts
here and stops on shutdown), settings (`/settings`), model import and
edit (`/models/import`, ...), OpenAPI (`/swagger`, `/swagger.json`) and
the web UI (`/`). The p2p layer is not ported yet (ROADMAP Queue A item
12). `transcribe` and `tts` run one model of the
models dir (or a preset) without the server. Its flags
mirror the env vars ApplicationConfig.from_env reads (LOCALAI_ADDRESS,
LOCALAI_PORT, LOCALAI_MODELS_PATH, ...), so either style works; `--device`
picks the engines' device (default `cuda`: the server refuses to start
without a GPU unless given `--device cpu`).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="localai-tpu-torch",
                                description="LocalAI-compatible server on one NVIDIA GPU")
    sub = p.add_subparsers(dest="command")
    run = sub.add_parser("run", help="start the API server (default)")
    run.add_argument("--address", default=None, help="bind address (LOCALAI_ADDRESS)")
    run.add_argument("--port", type=int, default=None, help="bind port (LOCALAI_PORT)")
    run.add_argument("--models-path", default=None, help="model configs dir (LOCALAI_MODELS_PATH)")
    run.add_argument("--api-key", action="append", default=None,
                     help="require this API key (repeatable)")
    run.add_argument("--max-active-models", type=int, default=None)
    run.add_argument("--preload", action="append", default=None,
                     help="model name to load at boot (repeatable)")
    run.add_argument("--debug", action="store_true")
    run.add_argument("--device", default="cuda", help="torch device of the engines (cuda | cpu)")
    models = sub.add_parser("models", help="list configured models")
    models.add_argument("--models-path", default=None)
    tr = sub.add_parser("transcribe", help="transcribe a WAV file locally")
    tr.add_argument("file")
    tr.add_argument("--model", default="whisper-tiny")
    tr.add_argument("--models-path", default=None)
    tr.add_argument("--language", default=None)
    tr.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    tts = sub.add_parser("tts", help="synthesize speech to a WAV file")
    tts.add_argument("text")
    tts.add_argument("--model", default="tts-base")
    tts.add_argument("--models-path", default=None)
    tts.add_argument("--voice", default=None)
    tts.add_argument("--output", default="out.wav")
    tts.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    sub.add_parser("version", help="print version")
    return p


def _run_local_audio(args, app_cfg) -> int:
    """The `transcribe` / `tts` one-shot commands: a model of the models
    dir, else a preset of that name, run without the HTTP server (the JAX
    CLI's commands)."""
    from localai_tpu_torch.audio import read_wav, resample, write_wav
    from localai_tpu_torch.config import ModelConfig
    from localai_tpu_torch.server import ModelManager

    manager = ModelManager(app_cfg, device=args.device)
    backend = "whisper" if args.command == "transcribe" else "tts"
    if manager.configs.get(args.model) is None:
        manager.configs.register(ModelConfig(name=args.model, model=args.model, backend=backend))
    try:
        lm = manager.get(args.model)
        if args.command == "transcribe":
            audio, sr = read_wav(args.file)
            print(lm.engine.transcribe(resample(audio, sr, 16_000), language=args.language)["text"])
        else:
            samples, sr = lm.engine.synthesize(args.text, voice=args.voice)
            write_wav(samples, sr, path=args.output)
            print(args.output)
    finally:
        manager.shutdown()
    return 0


def build_app(app_cfg, device="cuda"):
    """The manager, the router with every API layer the port serves
    registered (in the JAX CLI's order), and the agent-jobs service, not
    yet started."""
    from localai_tpu_torch.gallery import Gallery, GalleryService
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router
    from localai_tpu_torch.server.audio_api import AudioApi
    from localai_tpu_torch.server.image_api import ImageApi
    from localai_tpu_torch.server.gallery_api import GalleryApi
    from localai_tpu_torch.server.mcp_api import McpApi, make_job_runner
    from localai_tpu_torch.server.models_api import ModelsApi
    from localai_tpu_torch.server.openapi import register_openapi
    from localai_tpu_torch.server.realtime_api import RealtimeApi
    from localai_tpu_torch.server.rerank_api import RerankApi
    from localai_tpu_torch.server.settings_api import SettingsApi
    from localai_tpu_torch.server.stores_api import StoresApi
    from localai_tpu_torch.server.webui import register_webui
    from localai_tpu_torch.services import AgentJobService
    from localai_tpu_torch.stores import StoreRegistry

    manager = ModelManager(app_cfg, device=device)
    router = Router()
    oai = OpenAIApi(manager)
    oai.register(router)
    AudioApi(manager, oai).register(router)
    ImageApi(manager, oai, app_cfg.generated_content_dir).register(router)
    RerankApi(manager, oai).register(router)
    RealtimeApi(manager, oai).register(router)
    StoresApi(StoreRegistry(device=manager.device)).register(router)
    gallery_service = GalleryService(
        app_cfg.models_dir, config_loader=manager.configs,
        galleries=[Gallery(name=g["name"], url=g["url"]) for g in app_cfg.galleries],
        hf_endpoint=app_cfg.hf_endpoint)
    GalleryApi(gallery_service, manager=manager).register(router)
    jobs = AgentJobService(os.path.join(app_cfg.models_dir, "agent_jobs.json"),
                           make_job_runner(manager))
    McpApi(manager, oai, jobs=jobs).register(router)
    SettingsApi(app_cfg, manager).register(router)
    ModelsApi(manager).register(router)
    register_openapi(router)
    register_webui(router)
    return manager, router, jobs


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        argv = ["run"] + argv
    args = _build_parser().parse_args(argv)

    from localai_tpu_torch import __version__

    if args.command == "version":
        print(__version__)
        return 0
    from localai_tpu_torch.config import ApplicationConfig, ModelConfigLoader

    overrides = {}
    if args.models_path:
        overrides["models_dir"] = args.models_path
    if args.command == "models":
        cfg = ApplicationConfig.from_env(**overrides)
        for name, mc in sorted(ModelConfigLoader(cfg.models_dir).load_all().items()):
            print(f"{name}\tbackend={mc.backend}\tmodel={mc.model}")
        return 0
    if args.command in ("transcribe", "tts"):
        return _run_local_audio(args, ApplicationConfig.from_env(**overrides))

    if args.address:
        overrides["address"] = args.address
    if args.port is not None:
        overrides["port"] = args.port
    if args.api_key:
        overrides["api_keys"] = args.api_key
    if args.max_active_models:
        overrides["max_active_models"] = args.max_active_models
    if args.preload:
        overrides["preload_models"] = args.preload
    if args.debug:
        overrides["debug"] = True
    app_cfg = ApplicationConfig.from_env(**overrides)
    if not app_cfg.runtime_settings_path:
        app_cfg.runtime_settings_path = os.path.join(app_cfg.models_dir,
                                                     "runtime_settings.json")
    app_cfg.apply_runtime_settings()
    logging.basicConfig(level=logging.DEBUG if app_cfg.debug else logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    log = logging.getLogger("localai_tpu_torch")

    from localai_tpu_torch.server import create_server

    manager, router, jobs = build_app(app_cfg, device=args.device)
    jobs.start()
    for name in app_cfg.preload_models:
        log.info("preloading model %s", name)
        manager.get(name)
    server = create_server(app_cfg, router)

    def _stop(signum, frame):
        log.info("shutting down")
        jobs.stop()
        manager.shutdown()
        raise SystemExit(0)

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    log.info("localai-tpu-torch %s listening on %s:%d (device %s, models dir: %s, %d configs)",
             __version__, app_cfg.address, server.server_address[1], manager.device,
             app_cfg.models_dir, len(manager.configs.names()))
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
