"""Sweep: the kNN probe kernels' shape, on the card.

    python -m pointnet2_tpu_torch.tools.knn_shape_sweep

``csrc/knn_probes.cu`` builds one instance of each kernel at the shape its
``kQ`` (queries a warp) and ``kV`` (words of keys a lane) fix, and
``ops.cuda.probes.knn_plan`` gives the warps a block. This tool builds a
copy of the source at each ``(kQ, kV)`` of ``SHAPES`` (the two constants
rewritten; ``nvcc`` with ``ops.cuda.build``'s flags, all at once, into
``build/knn_sweep/``), points the wrappers at each library in turn and, at
each of ``WARPS`` warps a block, holds both kernels bit for bit against
row 3 (``cuda.knn``) and takes their device ms (``utils.bench.device_ms``)
at ``CASES``: the probe shape (64 clouds, 8192 queries, 1024 references, k
= 3) and SA1's kNN grouping (16 x 1024 x 8192, k = 32). It prints one JSON
line a shape and warps, with ptxas' registers and spills, row 3's device
ms and the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess

import numpy as np
import torch

from pointnet2_tpu_torch.ops import cuda
from pointnet2_tpu_torch.ops.cuda import build, common
from pointnet2_tpu_torch.ops.cuda import probes as cuda_probes
from pointnet2_tpu_torch.utils.bench import card_line, device_ms, require_device

SHAPES = ((1, 4), (1, 8), (2, 4), (2, 8), (4, 4), (4, 8))  # (kQ, kV)
WARPS = (4, 8, 16)
CASES = (("probe shape", 64, 8192, 1024, 3), ("SA1 k=32", 16, 1024, 8192, 32))  # (label, B, Nq, M, k)


def ptxas_lines(log: str) -> dict:
    """Each kNN kernel's registers and spills from ptxas' ``-v`` report."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = next((k for k in ("knn_argmin_kernel", "knn_tracked_kernel") if k in line), None)
        elif kernel and ("spill" in line or "Used" in line):
            out[kernel] = f"{out.get(kernel, '')} {line.split(':', 1)[-1].strip()}".strip()
    return out


def build_shapes(shapes=SHAPES) -> dict:
    """``(kQ, kV)`` -> (library path, ptxas' lines for the two kernels)."""
    out = build.BUILD_DIR / "knn_sweep"
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    source = (build.CSRC_DIR / "knn_probes.cu").read_text()
    procs = {}
    for q, v in shapes:
        text = re.sub(r"constexpr int kQ = \d+;", f"constexpr int kQ = {q};", source, count=1)
        text = re.sub(r"constexpr int kV = \d+;", f"constexpr int kV = {v};", text, count=1)
        cu = out / f"knn_q{q}_v{v}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[(q, v)] = lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for shape, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kNN shape {shape}:\n{log}")
        built[shape] = lib, ptxas_lines(log)
    return built


def main() -> list:
    require_device("cuda")
    card = card_line()
    rng = np.random.RandomState(0)
    inputs = []
    for label, b, nq, m, k in CASES:
        refs = torch.from_numpy((rng.rand(b, m, 3) * 10).astype(np.float32)).cuda()
        queries = torch.from_numpy((rng.rand(b, nq, 3) * 10).astype(np.float32)).cuda()
        row3 = cuda.knn(refs, queries, k)
        inputs.append((label, refs, queries, k, row3, device_ms(lambda: cuda.knn(refs, queries, k), "knn")))
    plan, lines = cuda_probes.knn_plan, []
    try:
        for (q, v), (lib, ptxas) in build_shapes().items():
            build._loaded["knn_probes"] = ctypes.CDLL(str(lib))
            for key in [key for key in common._entries if key[0] == "knn_probes"]:
                del common._entries[key]
            for warps in WARPS:
                cuda_probes.knn_plan = lambda b, m, nq, k, w=warps: (w, plan(b, m, nq, k)[1])
                line = {"kq": q, "v": v, "warps": warps, "ptxas": ptxas, "card": card}
                for label, refs, queries, k, row3, row3_ms in inputs:
                    for name in ("knn_argmin", "knn_tracked"):
                        got = getattr(cuda, name)(refs, queries, k)
                        if not all(torch.equal(g, r) for g, r in zip(got, row3)):
                            raise AssertionError(f"{name} at kQ={q}, kV={v}, {warps} warps misses row 3 at {label}")
                        line[f"{name} {label}"] = device_ms(lambda name=name: getattr(cuda, name)(refs, queries, k), name)
                    line[f"row 3 {label}"] = row3_ms
                print(json.dumps(line), flush=True)
                lines.append(line)
    finally:
        cuda_probes.knn_plan = plan
        build._loaded.pop("knn_probes", None)
        for key in [key for key in common._entries if key[0] == "knn_probes"]:
            del common._entries[key]
    return lines


if __name__ == "__main__":
    main()
