"""The parallel layer on the card: ranks sharing one CUDA device over
gloo, every kernel of their paths launched.  The tests carry the
``cuda`` marker and skip without a card; the file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

- ``dryrun_multichip(4)`` on the card prints every token and launches
  B1, B2, B4f, B4b, B5, B6 and B8 under the mesh on every rank;
- the exchange on 2 ranks on the card gives, bit for bit, what the same
  2 ranks give on the CPU (a gather, and B2's in-order sums).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ncf_tpu_torch.parallel import workers  # noqa: E402
from ncf_tpu_torch.parallel.dryrun import dryrun_report  # noqa: E402

# B3 takes batches of 4,096 rows or more; the dryrun's are tiny
KERNELS = ("tree_sample_negatives", "onehot_scatter_add", "fused_tower_fwd",
           "fused_tower_bwd", "topk_scores_streaming",
           "topk_scores_streaming_int8", "topk_scores_pallas")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dryrun_on_the_card(cuda):
    line, launches = dryrun_report(4, device="cuda")
    for tok in ("sharded_tables=2", "all_to_all=ok", "sharded_topk=ok",
                "sharded_topk_prepared=ok", "sharded_topk_int8=ok",
                "fused_tower_mesh=ok", "sequence_mesh=ok"):
        assert tok in line, (tok, line)
    assert len(launches) == 4
    for name in KERNELS:
        assert all(r[name] > 0 for r in launches), (name, launches)


@pytest.mark.cuda
def test_exchange_on_the_card_equals_the_cpu(cuda, tmp_path):
    rng = np.random.default_rng(0)
    N, D, W, n = 64, 8, 2, 40
    arrays = {"table": rng.normal(size=(N, D)).astype(np.float32),
              "ids": rng.integers(0, N, (W, n)),
              "g": rng.normal(size=(W, n, D)).astype(np.float32),
              "small": rng.normal(size=(N // W, D)).astype(np.float32),
              "small_ids": rng.integers(0, N // W, (W, 5))}
    outs = {}
    for dev in ("cpu", "cuda"):
        io = str(tmp_path / dev)
        workers.save_inputs(io, arrays, {"capacity_factor": 0.0})
        workers.run("exchange", W, io, device=dev)
        outs[dev] = [workers.load_outputs(io, r)[0] for r in range(W)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
