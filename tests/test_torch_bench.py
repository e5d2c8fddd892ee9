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
    assert kernels["three_interpolate_grad_sum_kernel"] == ["bool"]
    others = [s for key, s in KERNEL_SYMBOLS.items() if key != "three_interpolate_grad"]
    assert not any(s in k for s in others for k in grad)
