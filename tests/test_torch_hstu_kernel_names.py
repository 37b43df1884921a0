"""HSTU's attention kernels by name, as the benchmark's rooflines count
them, and the C entry points as the wrapper binds them.

``benchmark/metrics/hstu_attn_fwd_roofline.py`` and
``hstu_attn_bwd_roofline.py`` find the attention's device time by kernel
name: a profiler op counts when its name holds one of the metric's
``KERNELS``.  Read here from ``ops/csrc/hstu_attention.cu`` (comments
stripped): every ``__global__`` kernel that the backward's entry point
``ncf_hstu_attn_bwd`` reaches holds one of the backward's names and none
of the forward's, and the forward's entry ``ncf_hstu_attn_fwd`` reaches
only ``hstu_attn_fwd_kernel``, which holds none of the backward's.  So
each metric counts all of its pass's time and none of the other's.
"""

import os
import re

import pytest

from benchmark.metrics import hstu_attn_bwd_roofline, hstu_attn_fwd_roofline
from ncf_tpu_torch.ops import hstu_attention

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ncf_tpu_torch", "ops", "csrc", "hstu_attention.cu")


def _source():
    with open(SRC) as f:
        text = f.read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"__launch_bounds__\([^()]*\)", "", text)


def _functions(src):
    """{name: body} of the functions defined at the file's top level or
    in its anonymous namespace (a definition's name opens a line)."""
    out = {}
    for m in re.finditer(r"^(?:[A-Za-z_][^\n;{}()]*?\b)?(\w+)\(", src, re.M):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        j = i
        while src[j] not in "{;":
            j += 1
        if src[j] == ";":
            continue
        depth, k = 1, j + 1
        while depth:
            depth += {"{": 1, "}": -1}.get(src[k], 0)
            k += 1
        out[m.group(1)] = src[j:k]
    return out


def _reached(fns, entry):
    seen, todo = set(), [entry]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo += [f for f in fns if f not in seen
                 and re.search(rf"\b{f}\b", fns[name])]
    return seen


@pytest.fixture(scope="module")
def parsed():
    src = _source()
    return _functions(src), set(re.findall(r"__global__\s+void\s+(\w+)\s*\(",
                                           src))


def _counted(name, metric):
    return any(k in name for k in metric.KERNELS)


def test_every_kernel_of_the_backward_is_counted(parsed):
    fns, kernels = parsed
    bwd = _reached(fns, "ncf_hstu_attn_bwd") & kernels
    assert bwd == {"hstu_attn_bwd_dkdv_kernel", "hstu_attn_bwd_dq_kernel",
                   "hstu_bias_reduce_kernel"}
    assert all(_counted(k, hstu_attn_bwd_roofline) for k in bwd)
    assert not any(_counted(k, hstu_attn_fwd_roofline) for k in bwd)


def test_the_forward_is_one_kernel_counted_once(parsed):
    fns, kernels = parsed
    fwd = _reached(fns, "ncf_hstu_attn_fwd") & kernels
    assert fwd == {"hstu_attn_fwd_kernel"}
    assert _counted("hstu_attn_fwd_kernel", hstu_attn_fwd_roofline)
    assert not _counted("hstu_attn_fwd_kernel", hstu_attn_bwd_roofline)
    assert kernels == fwd | (_reached(fns, "ncf_hstu_attn_bwd") & kernels)


@pytest.mark.parametrize("entry", (hstu_attention.C_FWD,
                                   hstu_attention.C_BWD))
def test_the_bindings_match_the_c_prototypes(entry):
    lib, fn, codes = entry
    found = dict(re.findall(r"^int (ncf_\w+)\(([^)]*)\)", _source(), re.M))
    got = ""
    for a in found[fn].split(","):
        a = a.strip()
        got += ("p" if "*" in a else "l" if "long long" in a
                else "f" if a.startswith("float") else "i")
    assert lib == "hstu_attention" and got == codes


def test_the_constants_match_the_source():
    src = _source()
    for name, value in (("kRows", hstu_attention.TILE),
                        ("kDim", hstu_attention.MAX_DIM),
                        ("kBuckets", hstu_attention.BUCKETS),
                        ("kGroup", hstu_attention.GROUP)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
