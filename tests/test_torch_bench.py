"""``utils.bench.KERNEL_SYMBOLS`` against the kernels in ``csrc/``, on the CPU.

The profiles (``predict_profile``, ``train_profile``) and ``device_ms`` find a
kernel's device time by a part of its name as the profiler prints it:
``name(`` for a plain kernel, ``name<arg, ...>`` for a template. A symbol that
names a kernel no source defines, or gives it the wrong number of template
arguments, matches nothing on the card, and the kernel's time falls into
another category. These tests read the sources, so they run without a card.
"""

import pathlib
import re

import pytest

from pointnet2_tpu_torch.utils.bench import KERNEL_SYMBOLS

CSRC = pathlib.Path(__file__).resolve().parents[1] / "pointnet2_tpu_torch" / "csrc"
KERNEL = re.compile(
    r"(?:template\s*<([^<>]*)>\s*)?__global__\s+void\s+"
    r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\("
)


def _kernels() -> dict[str, list[str]]:
    """Kernel name -> the types of its template parameters ([] for a plain kernel)."""
    out = {}
    for path in sorted(CSRC.glob("*.cu*")):
        for params, name in KERNEL.findall(path.read_text()):
            out[name] = [p.split()[0] for p in params.split(",")] if params.strip() else []
    return out


def _literal_fits(arg: str, kind: str, partial: bool) -> bool:
    if kind == "bool":
        return any(v.startswith(arg) if partial else v == arg for v in ("true", "false"))
    if kind == "int":
        return arg.isdigit()
    return bool(arg)


def test_the_sources_define_the_kernels():
    kernels = _kernels()
    assert kernels["ball_query_tiles_kernel"] == ["bool", "bool"]
    assert kernels["ball_query_kernel"] == [] and kernels["fps_kernel"] == ["bool", "int"]


@pytest.mark.parametrize("key", sorted(KERNEL_SYMBOLS))
def test_kernel_symbol_names_a_kernel_of_the_sources(key):
    symbol = KERNEL_SYMBOLS[key]
    kernels = _kernels()
    name, rest = re.fullmatch(r"(\w+)(.*)", symbol).groups()
    if symbol.endswith("_"):  # a prefix: every kernel of an op that runs several
        assert any(k.startswith(symbol) for k in kernels), f"{key}: no kernel starts with {symbol}"
        return
    assert name in kernels, f"{key}: no kernel {name} in {CSRC}"
    params = kernels[name]
    if rest == "(":
        assert params == [], f"{key}: {name} is a template, the profiler prints it with <...>"
    elif rest:
        assert rest.startswith("<") and params, f"{key}: {symbol!r} does not match how {name} prints"
        closed = rest.endswith(">")
        args = [a.strip() for a in rest[1:len(rest) - closed].split(",")]
        if closed:
            assert len(args) == len(params), f"{key}: {name} takes {len(params)} template arguments"
        else:
            assert len(args) <= len(params), f"{key}: {name} takes {len(params)} template arguments"
        for i, (arg, kind) in enumerate(zip(args, params)):
            partial = not closed and i == len(args) - 1
            assert (partial and not arg) or _literal_fits(arg, kind, partial), f"{key}: {arg!r} is no {kind}"


def test_the_backward_symbol_names_all_its_kernels_and_no_other():
    """three_interpolate_grad runs three kernels, all in its profile category;
    the forward's symbol matches none of them."""
    kernels = _kernels()
    grad = sorted(k for k in kernels if k.startswith(KERNEL_SYMBOLS["three_interpolate_grad"]))
    assert grad == [f"three_interpolate_grad_{part}_kernel" for part in ("fill", "sum", "zero")]
    assert kernels["three_interpolate_grad_sum_kernel"] == ["typename", "typename", "bool"]  # <TG, TD, kVec>
    others = [s for key, s in KERNEL_SYMBOLS.items() if key != "three_interpolate_grad"]
    assert not any(s in k for s in others for k in grad)


def test_sass_probe_counts_opcodes_by_function():
    from pointnet2_tpu_torch.tools import sass_probe

    sass = """
        Function : _ZN12_GLOBAL__N_120window_gather_kernelIfLi8ELb0EEEvPKT_PKiS6_iiiiiPS2_
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                            /* 0x0000000000007919 */
        /*0020*/              @!P0 BRA 0x70 ;                                    /* 0x0000000000008947 */
        /*0030*/                   CALL.REL.NOINC 0x400 ;                        /* 0x0000000000007944 */
        /*0040*/               @P1 STG.E.128 desc[UR4][R2.64], R4 ;             /* 0x0000000402001986 */
        Function : _Z5otherv
        /*0000*/                   EXIT ;                                        /* 0x000000000000794d */
    """
    got = sass_probe.functions(sass)
    assert list(got) == ["_ZN12_GLOBAL__N_120window_gather_kernelIfLi8ELb0EEEvPKT_PKiS6_iiiiiPS2_", "_Z5otherv"]
    first = got["_ZN12_GLOBAL__N_120window_gather_kernelIfLi8ELb0EEEvPKT_PKiS6_iiiiiPS2_"]
    assert first == {"LDC": 1, "S2R": 1, "BRA": 1, "CALL": 1, "STG": 1}
    assert got["_Z5otherv"] == {"EXIT": 1}


class _Session:
    """A stand-in for ``torch.profiler.profile``: each session reports the
    next (places of the timed launches kept, device us) of ``recorded`` for
    one kernel, of ``issued`` runtime launches inside the ``TIMED`` range
    (listed latest first: places go by start time) and two lead-in launches
    before it whose kernels are lost."""

    def __init__(self, recorded, symbol, issued=5):
        self.recorded, self.symbol, self.issued = recorded, symbol, issued

    def __call__(self, activities):
        return self

    def __enter__(self):
        self.kept, self.us = next(self.recorded)
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        from torch.autograd import DeviceType

        from pointnet2_tpu_torch.utils import bench

        def event(i, device, name, start, end):
            return type("Event", (), {"id": i, "device_type": device, "name": name,
                                      "time_range": type("Range", (), {"start": start, "end": end,
                                                                       "elapsed_us": lambda self: end - start})()})()

        each = self.us / max(1, len(self.kept))
        return ([event(0, DeviceType.CPU, bench.TIMED, 0.0, 1000.0)]
                + [event(-1 - i, DeviceType.CPU, "cudaLaunchKernelExC", -10.0 * (i + 1), 0.0) for i in range(2)]
                + [event(100 + i, DeviceType.CPU, "cudaLaunchKernelExC", 10.0 * (self.issued - i), 0.0)
                   for i in range(self.issued)]
                + [event(100 + i, DeviceType.CUDA, f"{self.symbol}<8, true>(float*)", 0.0, each) for i in self.kept])


@pytest.mark.parametrize("counted", [True, False], ids=["launches counted", "launches given"])
def test_device_ms_runs_a_session_that_lost_launches_again(monkeypatch, counted):
    """Only the launches of a session's timed calls count (the tracer loses
    a session's first launches: lead-in calls come first, and what they lose
    does not matter). A session that keeps fewer of the kernel's timed
    launches than were issued (the rise of ``ops.cuda.LAUNCHES``, or
    ``launches`` a call for a kernel whose wrapper counts none) is run again
    with twice the lead, and the first whole session gives the time. When
    every session comes back short, or empty, a warning (for short ones,
    with each one's lead and the places of its lost launches) and the
    call's time by CUDA events."""
    import torch
    import torch.profiler

    from pointnet2_tpu_torch.ops.cuda import common
    from pointnet2_tpu_torch.utils import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(bench, "cuda_ms", lambda fn, **kw: 7.0)
    monkeypatch.setattr(common, "LAUNCHES", common.LAUNCHES.copy())

    def call():
        if counted:
            common.LAUNCHES["fps_remask"] += 1

    kwargs = {} if counted else {"launches": 1}
    symbol = bench.KERNEL_SYMBOLS["fps_remask"]
    monkeypatch.setattr(torch.profiler, "profile",
                        _Session(iter([((0, 1, 2), 30.0), ((), 0.0), (range(5), 50.0)]), symbol))
    assert bench.device_ms(call, "fps_remask", calls=5, **kwargs) == pytest.approx(50.0 / 1e3 / 5)
    monkeypatch.setattr(torch.profiler, "profile",
                        _Session(iter([((0, 1, 2), 45.0), ((), 0.0), ((1, 2, 3, 4), 48.0)]), symbol))
    with pytest.warns(RuntimeWarning, match=r"fps_remask .* every one of 3 sessions: 3 of 5 after a lead of 1 "
                      r"calls \(lost at \[0, 1\] of 5 launches\); 4 of 5 after a lead of 4 calls \(lost at "
                      r"\[4\] of 5 launches\); timing the whole call by CUDA"):
        assert bench.device_ms(call, "fps_remask", calls=5, **kwargs) == 7.0
    monkeypatch.setattr(torch.profiler, "profile", _Session(iter([((), 0.0)] * 3), symbol))
    with pytest.warns(RuntimeWarning, match="no device time for fps_remask"):
        assert bench.device_ms(call, "fps_remask", calls=5, **kwargs) == 7.0


def test_profiler_losses_runs_on_the_card_only(monkeypatch):
    """``tools.profiler_losses`` times nothing on the CPU: without a card it
    raises before any session, as every tool asked for the card does."""
    import torch

    from pointnet2_tpu_torch.tools import profiler_losses

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler_losses.main(["--sessions", "1"])
