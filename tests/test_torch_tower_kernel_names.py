"""B4b's kernels by name, as ``benchmark/metrics/b4b_roofline.py`` counts them.

The metric finds B4b's device time by kernel name: a profiler op counts
when its name holds one of ``b4b_roofline.KERNELS``.  Read here from
``ops/csrc/fused_tower.cu`` (comments stripped): every ``__global__``
kernel that the backward's entry point ``ncf_tower_bwd`` reaches, through
the functions of the file it calls, holds one of those names, and every
kernel the forward's entry ``ncf_tower_fwd`` reaches, ``tower_fwd_kernel``
among them, holds none.  So the metric counts all of B4b's time and none
of B4f's.
"""

import os
import re

import pytest

from benchmark.metrics import b4b_roofline

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ncf_tpu_torch", "ops", "csrc", "fused_tower.cu")


def _source():
    """The source without comments and without ``__launch_bounds__(...)``
    (its arguments may call functions)."""
    with open(SRC) as f:
        text = f.read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    while "__launch_bounds__(" in text:
        i = text.index("__launch_bounds__(")
        depth, j = 1, i + len("__launch_bounds__(")
        while depth:
            depth += {"(": 1, ")": -1}.get(text[j], 0)
            j += 1
        text = text[:i] + text[j:]
    return text


def _functions(src):
    """{name: body} of the functions defined at the file's top level (a
    definition's name opens a line at column 0)."""
    out = {}
    for m in re.finditer(r"^(?:[A-Za-z_][^\n;{}()]*?\b)?(\w+)\(", src, re.M):
        name = m.group(1)
        depth, i = 1, m.end()
        while depth:                       # past the parameter list
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        j = i
        while src[j] not in "{;":
            j += 1
        if src[j] == ";":
            continue                       # a declaration
        depth, k = 1, j + 1
        while depth:
            depth += {"{": 1, "}": -1}.get(src[k], 0)
            k += 1
        out[name] = src[j:k]
    return out


def _kernels(src):
    return set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", src))


def _reached(fns, entry):
    """The functions of the file that ``entry`` calls or names, at any
    depth, ``entry`` included."""
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
    return _functions(src), _kernels(src)


def _counted(name):
    return any(k in name for k in b4b_roofline.KERNELS)


def test_every_kernel_of_the_backward_is_counted(parsed):
    fns, kernels = parsed
    bwd = _reached(fns, "ncf_tower_bwd") & kernels
    assert {"tower_bwd_kernel", "reduce_partials"} <= bwd
    assert all(_counted(k) for k in bwd), sorted(bwd)


def test_no_kernel_of_the_forward_is_counted(parsed):
    fns, kernels = parsed
    fwd = _reached(fns, "ncf_tower_fwd") & kernels
    assert fwd == {"tower_fwd_kernel"}
    assert not any(_counted(k) for k in fwd), sorted(fwd)


def test_every_kernel_belongs_to_one_entry(parsed):
    fns, kernels = parsed
    bwd = _reached(fns, "ncf_tower_bwd") & kernels
    fwd = _reached(fns, "ncf_tower_fwd") & kernels
    assert kernels == bwd | fwd and not bwd & fwd
