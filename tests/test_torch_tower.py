"""Port parity for the fused MLP tower (kernels B4f/B4b, ``ops/tower.py``)
on the CPU, where ``fused_tower`` runs its plain version
``fused_tower_ref``, against ``ncf_tpu.ops.pallas_tower.fused_tower`` in
Pallas interpret mode.

Tolerances: the forward within atol 1e-5 of the reference for at least
99% of its outputs and within 2e-2 for all (f32 sums in another order;
where they straddle a bf16 rounding boundary between layers, that row
moves by up to ~1e-2); every gradient leaf within 1e-5 of its largest
magnitude (both backwards run in f32) and dx, which leaves in bf16,
within one bf16 ulp beyond that, on the rows whose forwards met no such flip (at
least 95% of them; the loss weighs the others out).  With
dropout, the plain version's backward is held against autograd through a
plain forward that applies the same masks, within 2e-2 of each leaf's
largest magnitude (``test_pallas_tower.py:70``'s bound: autograd rounds
the gradient to bf16 at every layer boundary, the fused backward does
not).  Train steps with ``fused_tower: "interpret"`` in both packages:
params within 5e-5 of their largest magnitude per leaf, as in
``test_torch_train_step.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ncf_tpu.data import sampler as jsampler  # noqa: E402
from ncf_tpu.models import advanced_ncf as jmodel  # noqa: E402
from ncf_tpu.models.layers import mlp_tower_init  # noqa: E402
from ncf_tpu.ops import pallas_tower as jtower  # noqa: E402
from ncf_tpu.train import optim as joptim  # noqa: E402
from ncf_tpu.train import step as jstep  # noqa: E402
from ncf_tpu.utils.config import Config as JConfig  # noqa: E402
from ncf_tpu_torch.convert import (adam_state_from_numpy,  # noqa: E402
                                   params_from_numpy, tree_leaves)
from ncf_tpu_torch.data import BatchIterator, generate_interactions  # noqa: E402
from ncf_tpu_torch.models import advanced_ncf as tmodel  # noqa: E402
from ncf_tpu_torch.models.layers import mlp_tower  # noqa: E402
from ncf_tpu_torch.ops import tower  # noqa: E402
from ncf_tpu_torch.train import optim as toptim  # noqa: E402
from ncf_tpu_torch.train import step as tstep  # noqa: E402
from ncf_tpu_torch.utils.config import Config  # noqa: E402

LEAVES = (("dense", "w"), ("dense", "b"), ("norm", "scale"), ("norm", "bias"))


def _layers(in_dim, hidden, seed=0):
    tree = jax.tree.map(np.asarray, mlp_tower_init(
        jax.random.PRNGKey(seed), in_dim, hidden))
    rng = np.random.default_rng(seed)
    # move the LayerNorm params off (1, 0) so their gradients are general
    return jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(
        np.float32), tree)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_forward_close(got, want):
    """At least 99% of the outputs within 1e-5 and all within 2e-2: where
    the two f32 sums of a layer straddle a bf16 rounding boundary, the
    next layer's input differs by one bf16 ulp (2^-8 relative), which
    moves the outputs of that row by up to ~1e-2."""
    err = np.abs(got - want)
    assert err.max() <= 2e-2, err.max()
    assert (err > 1e-5).mean() <= 0.01, (err > 1e-5).mean()


def _jfused(layers, x):
    return jtower.fused_tower(jax.tree.map(jnp.asarray, layers),
                              jnp.asarray(x), 0.0, None, True, interpret=True)


@pytest.mark.parametrize("shape", [(300, 24), (40, 5, 24), (1024 + 137, 24),
                                   (1, 24)])
def test_forward_matches_the_interpret_kernel(shape):
    layers = _layers(24, [32, 16, 8])
    x = _x(shape, 1)
    want = np.asarray(_jfused(layers, x))
    got = tower.fused_tower_ref(params_from_numpy(layers, "cpu"),
                                torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_forward_close(got.numpy(), want)
    # on CPU tensors the public entry point is the plain version
    same = tower.fused_tower(params_from_numpy(layers, "cpu"),
                             torch.from_numpy(x))
    assert torch.equal(same, got)


@pytest.mark.parametrize("shape,hidden", [((300, 24), [32, 16, 8]),
                                          ((30, 7, 20), [40, 12]),
                                          ((1100, 24), [16])])
def test_gradients_match_the_interpret_kernel(shape, hidden):
    """The loss weighs out the rows whose forwards met a bf16 flip (their
    outputs differ by more than 1e-5), so the backwards are compared on
    the same bf16 activations: tight there."""
    layers = _layers(shape[-1], hidden, seed=len(hidden))
    x = _x(shape, 2)
    tl = params_from_numpy(layers, "cpu")
    want_out = np.asarray(_jfused(layers, x))
    got_out = tower.fused_tower_ref(tl, torch.from_numpy(x)).numpy()
    same = (np.abs(got_out - want_out) <= 1e-5).all(-1, keepdims=True)
    assert same.mean() >= 0.95
    weight = same.astype(np.float32)

    def jloss(l, xx):
        return (jtower.fused_tower(l, xx, 0.0, None, True, interpret=True)
                ** 2 * weight).sum()

    gl, gx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, layers), jnp.asarray(x))
    for layer in tl:
        for a, b in LEAVES:
            layer[a][b].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tower.fused_tower_ref(tl, xt) ** 2 * torch.from_numpy(weight)).sum(
        ).backward()
    for i, layer in enumerate(tl):
        for a, b in LEAVES:
            want = np.asarray(gl[i][a][b])
            got = layer[a][b].grad.numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (
                i, a, b)
    # dx leaves in bf16: where the f32 values round to neighbouring bf16
    # numbers they are one ulp (2^-7 relative at most) apart, besides the
    # f32 sums' own 1e-5 of the largest magnitude (cancellation)
    want = np.asarray(gx, np.float32)
    assert xt.grad.dtype == torch.float32
    err = np.abs(xt.grad.numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want)
            + 1e-5 * np.abs(want).max()).all()
    assert (err > 0).mean() <= 0.01


def test_tower_fits_matches_the_reference():
    for in_dim in (1, 96, 129, 160, 384, 385, 512, 600):
        for hidden in ([256, 128, 64], [64], [512, 512, 64], [384],
                       [128] * 9, [128] * 10, [256] * 3, [256] * 4, [1024]):
            layers = [{"dense": {"w": np.zeros((1, h))}} for h in hidden]
            assert tower.tower_fits(layers, in_dim) == \
                jtower.tower_fits(layers, in_dim), (in_dim, hidden)


def test_philox_matches_the_published_vectors():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        t = [torch.tensor(v, dtype=torch.int64) for v in ctr]
        k = [torch.tensor(v, dtype=torch.int64) for v in key]
        assert tuple(int(w) for w in tower.philox4x32(t, k)) == want
    # the mask words: counter (row, col // 4), word col % 4
    bits = tower.dropout_bits(torch.tensor([77], dtype=torch.int32), 2, 3, 10)
    r, c = 2, 9
    words = tower.philox4x32([torch.tensor(v) for v in (r, c // 4, 0, 0)],
                             [torch.tensor(77), torch.tensor(2)])
    assert int(bits[r, c]) == int(words[c % 4])


@pytest.mark.parametrize("rate", (0.2, 0.5))
def test_dropout_zeroes_its_rate(rate):
    layers = params_from_numpy(_layers(24, [256]), "cpu")
    x = torch.from_numpy(_x((2000, 24), 3))
    gen = torch.Generator().manual_seed(5)
    out = tower.fused_tower(layers, x, rate, gen, deterministic=False)
    zeroed = float((out == 0).float().mean())
    assert abs(zeroed - rate) <= 0.01
    # the same generator state gives the same masks; eval mode none
    again = tower.fused_tower_ref(layers, x, rate,
                                  torch.Generator().manual_seed(5), False)
    assert torch.equal(out, again)
    assert not bool((tower.fused_tower(layers, x, rate, gen, True) == 0).any())


def _plain_with_masks(layers, x, seed, rate):
    """Autograd through a plain forward that applies the kernel's masks."""
    h = x.to(torch.bfloat16)
    for i, layer in enumerate(layers):
        w, b = layer["dense"]["w"], layer["dense"]["b"]
        z = torch.relu(h.float() @ w.to(torch.bfloat16).float() + b)
        n = z.shape[1]
        mean = z.sum(1, keepdim=True) / n
        xm = z - mean
        y = xm * torch.rsqrt((xm * xm).sum(1, keepdim=True) / n + 1e-5)
        y = y * layer["norm"]["scale"] + layer["norm"]["bias"]
        keep = tower.dropout_bits(seed, i, z.shape[0], n) < \
            tower.keep_threshold(rate)
        y = torch.where(keep, y * (1.0 / (1.0 - rate)), torch.zeros_like(y))
        h = y if i + 1 == len(layers) else y.to(torch.bfloat16)
    return h


def test_dropout_backward_equals_autograd_with_the_same_masks():
    rate = 0.2
    np_layers = _layers(24, [32, 16, 8], seed=4)
    x = _x((500, 24), 6)
    runs = []
    for fn in ("fused", "plain"):
        tl = params_from_numpy(np_layers, "cpu")
        for layer in tl:
            for a, b in LEAVES:
                layer[a][b].requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        gen = torch.Generator().manual_seed(9)
        if fn == "fused":
            out = tower.fused_tower_ref(tl, xt, rate, gen, False)
        else:
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 dtype=torch.int32)
            out = _plain_with_masks(tl, xt, seed, rate)
        (out ** 2).sum().backward()
        runs.append((out.detach(), [layer[a][b].grad for layer in tl
                                    for a, b in LEAVES], xt.grad))
    (fo, fg, fx), (po, pg, px) = runs
    assert torch.equal(fo == 0, po == 0)             # identical masks
    torch.testing.assert_close(fo, po, rtol=0, atol=1e-5)
    for a, b in zip(fg + [fx], pg + [px]):
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


# ---------------------------------------------------------------- routing

def _model_cfg(mode, dtype="float32"):
    cfg = Config()
    m = cfg.model
    m.num_users, m.num_items = 50, 40
    m.mf_dim = m.mlp_dim = 16
    m.temporal_dim, m.mlp_hidden_dims = 8, [32, 16]
    m.compute_dtype, m.fused_tower = dtype, mode
    return cfg


def _apply(cfg):
    params = tmodel.init(torch.Generator().manual_seed(0), cfg.model)
    u = torch.arange(8)
    items = (torch.arange(8)[:, None].repeat(1, 3) * 7) % 40
    return tmodel.apply(params, cfg.model, u, items)


@pytest.mark.parametrize("mode,dtype,route", [
    ("auto", "float32", "plain"), ("auto", "bfloat16", "plain"),
    ("off", "bfloat16", "plain"), ("interpret", "float32", "fused"),
    ("on", "bfloat16", "fused")])
def test_routing_on_the_cpu(monkeypatch, mode, dtype, route):
    """``auto`` keeps the plain layers off the card (as the reference
    does off a TPU); ``on`` and ``interpret`` run fused semantics, which
    on the CPU is ``fused_tower_ref``."""
    calls = []
    real_fused, real_plain = tmodel.fused_tower, tmodel.mlp_tower
    monkeypatch.setattr(tmodel, "fused_tower", lambda *a, **k: (
        calls.append("fused"), real_fused(*a, **k))[1])
    monkeypatch.setattr(tmodel, "mlp_tower", lambda *a, **k: (
        calls.append("plain"), real_plain(*a, **k))[1])
    n0 = tower.fused_tower.fwd_launches.value
    out = _apply(_model_cfg(mode, dtype))
    assert calls == [route] and out.shape == (8, 3)
    assert tower.fused_tower.fwd_launches.value == n0   # no kernel on CPU


def test_fused_modes_raise_where_the_shape_does_not_fit():
    cfg = _model_cfg("on")
    cfg.model.mlp_hidden_dims = [1024, 16]
    with pytest.raises(ValueError, match="does not fit"):
        _apply(cfg)
    cfg.model.fused_tower = "auto"             # off the card: plain layers
    assert _apply(cfg).shape == (8, 3)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    layers = params_from_numpy(_layers(24, [32]), "cpu")
    flat = [layers[0][a][b] for a, b in LEAVES]
    x = torch.zeros((4, 24), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tower._check_cuda(x.float(), flat, [24, 32])
    with pytest.raises(ValueError):
        tower._check_cuda(x, flat, [24, 600])
    with pytest.raises(ValueError):
        tower._check_cuda(x, flat * 17, [24] + [32] * 17)
    with pytest.raises(ValueError):
        tower._check_cuda(x[:0], flat, [24, 32])
    with pytest.raises(RuntimeError, match="no tower kernel"):
        tower.fused_tower(layers, torch.zeros((4, 24), device="meta"))


def test_plain_tower_without_dropout_is_mlp_tower():
    """Fused semantics round x to bf16 first; on bf16 input and without
    dropout they are the plain layers up to f32 summation order."""
    layers = params_from_numpy(_layers(24, [32, 16, 8]), "cpu")
    x = torch.from_numpy(_x((64, 24), 8)).to(torch.bfloat16)
    torch.testing.assert_close(tower.fused_tower_ref(layers, x),
                               mlp_tower(layers, x, dtype=torch.bfloat16),
                               rtol=0, atol=1e-5)


# ------------------------------------------------------- train-step parity

@pytest.mark.parametrize("mode", ("joint", "independent"))
def test_three_steps_with_the_fused_tower_match(mode):
    users, items, B, K = 100, 60, 64, 3
    cfgs = []
    for cfg in (JConfig(), Config()):
        m, t = cfg.model, cfg.train
        m.num_users, m.num_items = users, items
        m.mf_dim = m.mlp_dim = 8
        m.temporal_dim, m.mlp_hidden_dims, m.num_heads = 4, [16, 8], 2
        m.num_departments, m.num_categories = 3, 5
        m.negative_samples, m.fused_tower = 4, "interpret"
        m.compute_dtype, m.dropout, m.candidate_mode = "float32", 0.0, mode
        t.batch_size, t.lr_schedule, t.weight_decay = B, "constant", 1e-3
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(0)
    dept = rng.integers(0, 3, items).astype(np.int32)
    cat = rng.integers(0, 5, items).astype(np.int32)
    cdf = np.array(jsampler.make_sampling_cdf(
        1.0 / rng.zipf(1.3, items).astype(np.float64)))
    inter = generate_interactions(num_users=users, num_items=items,
                                  num_days=30, avg_txns_per_user=6, seed=0)
    batches = list(BatchIterator(inter, B, seed=0).epoch(0))[:K]
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), jmodel.init(jax.random.PRNGKey(0), jcfg.model))

    opt = joptim.make_optimizer(jcfg.train, steps_per_epoch=K)
    jp = jax.tree.map(jnp.asarray, np_params)
    js = opt.init(jp)
    jrun = jstep.make_train_step(jmodel, jcfg, opt, jnp.asarray(cdf),
                                 jnp.asarray(dept), jnp.asarray(cat))
    key = jax.random.PRNGKey(5)
    negs = []
    for b in batches:
        _, step_rng = jax.random.split(key)
        rng_neg, _ = jax.random.split(step_rng)
        negs.append(np.asarray(jsampler.sample_negatives(
            rng_neg, jnp.asarray(b["item_ids"]), items, 4,
            cdf=jnp.asarray(cdf))))
        jp, js, key, _ = jrun(jp, js, key,
                              {k: jnp.asarray(v) for k, v in b.items()})

    params = params_from_numpy(np_params, "cpu")
    state = adam_state_from_numpy(jax.tree.map(np.asarray, joptim.make_optimizer(
        jcfg.train, K).init(jax.tree.map(jnp.asarray, np_params))), "cpu")
    multi = tstep.make_multi_train_step(
        tmodel, tcfg, toptim.make_optimizer(tcfg.train, K), cdf, dept, cat,
        device="cpu")
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    params, state, _, _ = multi(params, state, torch.Generator(), stacked,
                                np.stack(negs))
    got = [np.asarray(a.detach(), np.float64) for a in tree_leaves(params)]
    want = [np.asarray(b, np.float64) for b in jax.tree_util.tree_leaves(jp)]
    floor = 1e-7 * max(np.abs(b).max() for b in want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.abs(a - b).max() <= max(5e-5 * np.abs(b).max(), floor), i
