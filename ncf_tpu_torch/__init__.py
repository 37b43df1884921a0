"""ncf_tpu_torch — the PyTorch/CUDA port of ``ncf_tpu`` for NVIDIA Hopper.

The JAX package ``ncf_tpu`` stays the reference; this package mirrors its
module layout and names so each counterpart is found at the same path
(``ncf_tpu_torch.serving.scorer`` <-> ``ncf_tpu.serving.scorer``).  It
imports ``torch`` and numpy, never JAX and nothing of ``ncf_tpu``.

Ported so far: the serving path, ``ModelServer`` -> ``AdvancedNCFScorer``
-> ``ops.topk.topk_scores_streaming``, and the training step,
``train.step.make_train_step`` over AdvancedNCF in training mode with its
sampler, embedding-gradient scatter and temporal lookup-sum.  Each kernel
is hand-written CUDA C++ for ``sm_90a`` (``ops/csrc/*.cu``, built with
``nvcc`` at first use and bound with ``ctypes``).

Package layout
--------------
- ``ncf_tpu_torch.data``    — synthetic logs, interactions, the batch
                              iterator (NumPy copies) and the device
                              negative samplers.
- ``ncf_tpu_torch.evals``   — batch accuracy and rank metrics.
- ``ncf_tpu_torch.models``  — functional AdvancedNCF (plain dict params,
                              the JAX pytree's keys and [in, out] layout).
- ``ncf_tpu_torch.native``  — the port's copy of the C++ data loader.
- ``ncf_tpu_torch.ops``     — embedding lookup, top-k retrieval, sampler,
                              scatter-add, temporal sum and the CUDA
                              kernel loader.
- ``ncf_tpu_torch.serving`` — AdvancedNCFScorer and ModelServer.
- ``ncf_tpu_torch.train``   — the training step, Adam and schedules, and
                              checkpoint restore (npy manifest format).
- ``ncf_tpu_torch.utils``   — config (a copy of the JAX package's) and
                              device selection.
- ``ncf_tpu_torch.convert`` — numpy <-> port param trees and Adam state.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
