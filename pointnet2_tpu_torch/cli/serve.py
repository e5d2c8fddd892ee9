"""Serve a model of the port over HTTP with micro-batching, on the card.

    # from an exported artifact (tools.export_model; no model code needed):
    python -m pointnet2_tpu_torch.cli.serve --artifact result/export --port 8080

    # from a checkpoint of the port's train CLI (exported to a temporary directory first):
    python -m pointnet2_tpu_torch.cli.serve --ckpt log/semantic/model.pt --config_file semantic.json \\
        --batch 64 [--dtype bfloat16 --bf16_min_width 128] --port 8080

Counterpart of the root ``serve.py``, with its flags and ``--device``: the
device to serve on, by default the artifact's (with ``--ckpt``, CUDA, which
must be present). The daemon is ``pointnet2_tpu_torch.serving``:
``POST /v1/predict`` (JSON or ``.npy``), ``GET /healthz``, ``GET /stats``.
``build_server(argv)`` builds the server, warmed up, without serving.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

from pointnet2_tpu_torch.cli import cli_device
from pointnet2_tpu_torch.serving import PredictServer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", help="tools.export_model output directory")
    ap.add_argument("--ckpt", help="checkpoint of the port's train CLI, to export and serve")
    ap.add_argument("--config_file", default="semantic.json")
    ap.add_argument("--arch", default="ssg", choices=["ssg", "msg"])
    ap.add_argument("--batch", type=int, default=64, help="device batch (the export batch for --ckpt)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--bf16_min_width", type=int, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max_delay_ms", type=float, default=5.0, help="micro-batching coalescing window")
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument(
        "--device", default=None,
        help="torch device to serve on: by default the artifact's; with --ckpt, cuda, which must be present",
    )
    return ap


def build_server(argv: Optional[Sequence[str]] = None) -> PredictServer:
    """Parse ``argv``, export ``--ckpt`` if given, and return the server,
    bound and warmed up but not yet serving."""
    ap = build_parser()
    flags = ap.parse_args(argv)
    if bool(flags.artifact) == bool(flags.ckpt):
        ap.error("exactly one of --artifact / --ckpt is required")
    artifact = flags.artifact
    if flags.ckpt:
        from pointnet2_tpu_torch.config import Config
        from pointnet2_tpu_torch.export import export_model
        from pointnet2_tpu_torch.tools.export_model import trainer_from_checkpoint

        trainer = trainer_from_checkpoint(
            Config.from_json(flags.config_file), flags.ckpt, cli_device(flags.device or "cuda"), arch=flags.arch,
            dtype=flags.dtype, bf16_min_width=flags.bf16_min_width,
        )
        artifact = tempfile.mkdtemp(prefix="serve_export_")
        manifest = export_model(trainer, artifact, batch=flags.batch)
        print(f"exported {manifest['artifact_bytes'] / 1e6:.1f} MB -> {artifact}")
    return PredictServer(
        artifact, host=flags.host, port=flags.port, max_batch=flags.batch, max_delay_ms=flags.max_delay_ms,
        warmup=not flags.no_warmup, device=flags.device,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    server = build_server(argv)
    m = server.model.manifest
    print(
        f"serving {m['arch']} ({m['infer_dtype']}{', certified windows' if m.get('window_certificate') else ''}) "
        f"batch={server.model.max_batch} on {m['device']} at http://{server.httpd.server_address[0]}:{server.port}",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
