"""Every CUDA kernel of the port against the NumPy oracles, on the card.

    python -m pointnet2_tpu_torch.tools.parity [--device cpu] [--small] [--out FILE]

The counterpart of the JAX repo's ``tools/tpu_parity.py``, with its checks,
shapes, seeds (``numpy.random.RandomState(0)``) and names, so that the two
sweeps line up line by line, and the port's own checks after them. Each
check runs public ops of ``pointnet2_tpu_torch.ops`` with ``impl=None``: on
the card they launch the kernels (all eleven rows of PERF.md's table, the two
FPS entries among them), on the CPU (``--device cpu``) the plain versions.
The oracles are ``ops.reference``'s (the port's own copy). Index outputs must
be equal; floats within ``tpu_parity.py``'s tolerances: 3-NN distances
rtol=1e-5, atol=1e-6; three_interpolate relative max error < 1e-5, its
backward < 1e-4; the windowed 3-NN's distances equal the exact kernel's bit
for bit; the fused windowed grouping's rows equal the oracle-indexed rows of
the same projection bit for bit.

``--small`` runs the same checks at small shapes (that is how the CPU tests
drive the sweep). Output: one ``PASS``/``FAIL`` line a check, then one JSON
line ``{"checks": n, "failures": [...], "device": ...}``; the exit code is 0
only if every check passed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import reference
from pointnet2_tpu_torch.utils.bench import require_device

# tpu_parity.py's shapes (B, then (N, M[, radius or channels]) per level) and windows.
FULL = dict(
    fps_b=16, fps=[(8192, 1024), (1024, 256), (256, 64), (64, 16)],
    bq_b=8, bq=[(8192, 1024, 0.5), (1024, 256, 1.0), (256, 64, 2.0), (64, 16, 4.0)],
    bq_window=lambda n: 4096 if n > 4096 else n,
    pg_b=4, pg=[(8192, 1024, 0.5), (2048, 256, 0.5)],
    pg_window=lambda n: 4096 if n > 4096 else 1536,
    nn_b=8, nn=[(8192, 1024), (1024, 256), (256, 64), (64, 16)],
    nn_window=lambda m: 768 if m > 768 else m,
    ti_b=8, ti=[(8192, 1024, 128), (1024, 256, 256), (256, 64, 256), (64, 16, 512)],
    tib_b=2, tib=[(8192, 1024, 128), (1024, 256, 256), (64, 16, 512)],
    nm_b=2, nm=[(300, 100, 0.5), (1000, 37, 1.0), (8192, 129, 0.5)],
    extra_b=2, extra=(8192, 1024, 0.5),
)
# The same checks at sizes the CPU runs in seconds; the windows still engage.
SMALL = dict(
    fps_b=2, fps=[(1024, 256), (256, 64), (100, 30)],
    bq_b=2, bq=[(1024, 256, 0.5), (256, 64, 2.0), (64, 16, 4.0)],
    bq_window=lambda n: 768 if n > 768 else n,
    pg_b=2, pg=[(1024, 256, 0.5)],
    pg_window=lambda n: 768,
    nn_b=2, nn=[(1024, 512), (256, 64), (64, 16)],
    nn_window=lambda m: 384 if m > 384 else m,
    ti_b=2, ti=[(1024, 256, 32), (64, 16, 64)],
    tib_b=2, tib=[(1024, 256, 32), (64, 16, 64)],
    nm_b=2, nm=[(300, 100, 0.5), (1000, 37, 1.0)],
    extra_b=2, extra=(1024, 256, 0.5),
)


def run(device: torch.device, shapes: dict) -> list[tuple[str, bool]]:
    """Every check at ``shapes``; returns (name, passed) in order, printing each."""
    rng = np.random.RandomState(0)
    results: list[tuple[str, bool]] = []

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def np_(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()

    def check(name: str, ok) -> None:
        ok = bool(ok)
        print(f"{'PASS' if ok else 'FAIL'}  {name}", flush=True)
        results.append((name, ok))

    # FPS at the SA shapes: the index-only entry and the fused one with centroids.
    for n, m in shapes["fps"]:
        xyz = (rng.rand(shapes["fps_b"], n, 3) * 10).astype(np.float32)
        want = reference.farthest_point_sample_np(xyz, m)
        check(f"fps n={n} m={m}", (np_(ops.farthest_point_sample(t(xyz), m)) == want).all())
        fidx, fxyz = ops.fps_centroids(t(xyz), m)
        want_xyz = np.take_along_axis(xyz, want[..., None].astype(np.int64), axis=1)
        check(f"fps_centroids n={n} m={m}", (np_(fidx) == want).all() and (np_(fxyz) == want_xyz).all())

    # Ball query: exact, round-1 windowed, calibrated window.
    for n, m, r in shapes["bq"]:
        b = shapes["bq_b"]
        xyz1 = (rng.rand(b, n, 3) * [10, 10, 5]).astype(np.float32)
        xyz2 = np.stack([x[rng.choice(n, m, replace=False)] for x in xyz1]).astype(np.float32)
        wi, wc = reference.ball_query_np(xyz1, xyz2, r, 32)
        gi, gc = ops.ball_query(t(xyz1), t(xyz2), r, 32)
        check(f"ball_query n={n} m={m}", (np_(gi) == wi).all() and (np_(gc) == wc).all())
        gi, gc = ops.ball_query(t(xyz1), t(xyz2), r, 32, impl="windowed")
        check(f"ball_query_windowed n={n} m={m}", (np_(gi) == wi).all() and (np_(gc) == wc).all())
        w = shapes["bq_window"](n)
        gi, gc, ok = ops.ball_query_calibrated(t(xyz1), t(xyz2), r, 32, w)
        check(
            f"ball_query_sliced n={n} m={m} w={w}",
            bool(ok) and (np_(gi) == wi).all() and (np_(gc) == wc).all(),
        )

    # The fused windowed grouping: window columns and the window gather.
    for n, m, r in shapes["pg"]:
        b = shapes["pg_b"]
        xyz1 = (rng.rand(b, n, 3) * [10, 10, 5]).astype(np.float32)
        xyz2 = np.stack([x[rng.choice(n, m, replace=False)] for x in xyz1]).astype(np.float32)
        inputs = rng.rand(b, n, 6).astype(np.float32)
        inputs[..., :3] = xyz1
        w0 = (rng.randn(6, 32) * 0.1).astype(np.float32)
        b0 = (rng.randn(32) * 0.1).astype(np.float32)
        w = shapes["pg_window"](n)
        g_s, gidx, gcnt, _, inv_q, okw = ops.project_group_calibrated(
            t(inputs), t(w0), t(b0), t(xyz1), t(xyz2), r, 32, w
        )
        wi, wc = reference.ball_query_np(xyz1, xyz2, r, 32)
        zp = np_(t(inputs) @ t(w0) + t(b0))
        want_g = np.take_along_axis(zp, wi.reshape(b, m * 32)[..., None].astype(np.int64), axis=1)
        got_g = np_(g_s)
        if inv_q is not None:
            got_g = np.take_along_axis(got_g, np_(inv_q)[..., None, None], axis=1)
        check(
            f"project_group_sliced n={n} m={m} w={w}",
            bool(okw) and (np_(gidx) == wi).all() and (np_(gcnt) == wc).all()
            and (got_g == want_g.reshape(b, m, 32, 32)).all(),
        )

    # 3-NN at the FP shapes, exact and through a calibrated window.
    for nq, m in shapes["nn"]:
        b = shapes["nn_b"]
        tq = (rng.rand(b, nq, 3) * 10).astype(np.float32)
        s = (rng.rand(b, m, 3) * 10).astype(np.float32)
        wd, wi = zip(*(reference.three_nn_np(tq[i : i + 1], s[i : i + 1]) for i in range(b)))
        wd, wi = np.concatenate(wd), np.concatenate(wi)
        gd, gi = ops.three_nn(t(tq), t(s))
        check(
            f"three_nn nq={nq} m={m}",
            (np_(gi) == wi).all() and np.allclose(np_(gd), wd, rtol=1e-5, atol=1e-6),
        )
        w = shapes["nn_window"](m)
        gd2, gi2, ok2 = ops.three_nn_calibrated(t(tq), t(s), w)
        check(
            f"three_nn_sliced nq={nq} m={m} w={w}",
            bool(ok2) and (np_(gi2) == wi).all() and (np_(gd2) == np_(gd)).all(),
        )

    d2, idx = ops.knn(t(s), t(tq), 8)
    _, wi2 = reference.knn_np(s, tq, 8)
    check("knn k=8", (np_(idx) == wi2).all())

    # three_interpolate forward at the FP shapes. Its indices and weights come
    # from the port's 3-NN (held to the oracle above); the oracle is the blend.
    for n, m, c in shapes["ti"]:
        b = shapes["ti_b"]
        pts = rng.randn(b, m, c).astype(np.float32)
        t2 = (rng.rand(b, n, 3) * 10).astype(np.float32)
        s2 = (rng.rand(b, m, 3) * 10).astype(np.float32)
        wd, wi = ops.three_nn(t(t2), t(s2))
        ww = ops.interpolation_weights(wd)
        got = np_(ops.three_interpolate(t(pts), wi, ww))
        want = reference.three_interpolate_np(pts, np_(wi), np_(ww))
        rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)
        check(f"three_interpolate n={n} m={m} c={c} (rel {rel:.1e})", rel < 1e-5)

    # ... and its backward (both kernels behind autograd) against the exact scatter-add.
    for n, m, c in shapes["tib"]:
        b = shapes["tib_b"]
        pts = rng.randn(b, m, c).astype(np.float32)
        t2 = (rng.rand(b, n, 3) * 10).astype(np.float32)
        s2 = (rng.rand(b, m, 3) * 10).astype(np.float32)
        cot = rng.randn(b, n, c).astype(np.float32)
        wd, wi = ops.three_nn(t(t2), t(s2))
        ww = ops.interpolation_weights(wd)
        p = t(pts).requires_grad_()
        (gp,) = torch.autograd.grad(ops.three_interpolate(p, wi, ww), p, t(cot))
        wi_np, ww_np = np_(wi).astype(np.int64), np_(ww).astype(np.float64)
        want_g = np.zeros((b, m, c), np.float64)
        for bb in range(b):
            for j in range(3):
                np.add.at(want_g[bb], wi_np[bb, :, j], ww_np[bb, :, j, None] * cot[bb])
        rel = np.abs(np_(gp) - want_g).max() / max(np.abs(want_g).max(), 1e-9)
        check(f"three_interpolate_bwd n={n} m={m} c={c} (rel {rel:.1e})", rel < 1e-4)

    # Query counts that are not multiples of the tile.
    for n, m, r in shapes["nm"]:
        b = shapes["nm_b"]
        xyz1 = (rng.rand(b, n, 3) * [10, 10, 5]).astype(np.float32)
        xyz2 = (rng.rand(b, m, 3) * [10, 10, 5]).astype(np.float32)
        wi, wc = reference.ball_query_np(xyz1, xyz2, r, 16)
        gi, gc = ops.ball_query(t(xyz1), t(xyz2), r, 16)
        check(f"ball_query nonmultiple n={n} m={m}", (np_(gi) == wi).all() and (np_(gc) == wc).all())
        _, wi3 = reference.knn_np(xyz1, xyz2, 5)
        _, gi3 = ops.knn(t(xyz1), t(xyz2), 5)
        check(f"knn nonmultiple n={n} m={m}", (np_(gi3) == wi3).all())

    # The port's own: the round-1 windowed ball query where tiles fall back
    # (points crowded into a 0.2 m band of x) and with nsample past one warp.
    n, m, r = shapes["extra"]
    b = shapes["extra_b"]
    xyz1 = (rng.rand(b, n, 3) * [10, 10, 5]).astype(np.float32)
    xyz1[:, : n // 2, 0] = 4.9 + 0.2 * rng.rand(b, n // 2)
    xyz2 = np.stack([x[rng.choice(n, m, replace=False)] for x in xyz1]).astype(np.float32)
    wi, wc = reference.ball_query_np(xyz1, xyz2, r, 32)
    gi, gc = ops.ball_query(t(xyz1), t(xyz2), r, 32, impl="windowed")
    check(f"ball_query_windowed clustered n={n} m={m}", (np_(gi) == wi).all() and (np_(gc) == wc).all())
    wi, wc = reference.ball_query_np(xyz1, xyz2, 2 * r, 64)
    gi, gc = ops.ball_query(t(xyz1), t(xyz2), 2 * r, 64, impl="windowed")
    check(
        f"ball_query_windowed nsample=64 n={n} m={m}",
        (np_(gi) == wi).all() and (np_(gc) == wc).all(),
    )

    # kNN past the register route's k = 16 (one warp a query, its list in
    # shared memory), on the same crowded cloud: many equal x, few equal distances.
    q = xyz2[:, :128]
    wd4, wi4 = reference.knn_np(xyz1, q, 32)
    gd4, gi4 = ops.knn(t(xyz1), t(q), 32)
    check(f"knn k=32 n={n} m={q.shape[1]}", (np_(gi4) == wi4).all() and (np_(gd4) == wd4).all())

    # three_interpolate with the FP concat written by the same kernel, the skip
    # a strided view as FP4's colours are.
    n, m, c = shapes["ti"][0]
    b = shapes["ti_b"]
    pts = rng.randn(b, m, c).astype(np.float32)
    cloud = t(rng.rand(b, n, 6).astype(np.float32))
    wd, wi = ops.three_nn(cloud[..., :3].contiguous(), t((rng.rand(b, m, 3)).astype(np.float32)))
    ww = ops.interpolation_weights(wd)
    got = np_(ops.three_interpolate(t(pts), wi, ww, skip=cloud[..., 3:]))
    want = reference.three_interpolate_np(pts, np_(wi), np_(ww))
    rel = np.abs(got[..., :c] - want).max() / max(np.abs(want).max(), 1e-9)
    check(
        f"three_interpolate skip=3 n={n} m={m} c={c} (rel {rel:.1e})",
        rel < 1e-5 and (got[..., c:] == np_(cloud[..., 3:])).all(),
    )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="small shapes")
    ap.add_argument("--out", type=pathlib.Path, default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    results = run(device, SMALL if args.small else FULL)
    failures = [name for name, ok in results if not ok]
    summary = {
        "checks": len(results),
        "failures": failures,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        lines = [f"{'PASS' if ok else 'FAIL'}  {name}" for name, ok in results]
        args.out.write_text("\n".join(lines + [json.dumps(summary)]) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
