"""Environment validator — ``python -m ncf_tpu_torch.cli doctor``.

Port of ``ncf_tpu/utils/doctor.py``, the analogue of the reference's
setup validator (reference: scripts/0. setup/validate_setup.py:17-30,
which checks buckets / service accounts / BigQuery views / Vertex
endpoints before anything runs).  The same eight checks in the same
order: the config's invariants, the visible cards (every kernel is built
for ``sm_90a`` only, so a card that is not compute capability 9.0
fails), the kernels built with ``nvcc`` and one of them (B7) launched and
held to its plain version, the configured model's training footprint
against the card's memory, the mesh of ranks against the process group,
artifact-store writability, the native data-loader build, and
(optionally) redis reachability.

Each check returns (name, status, message) with status in {"ok",
"warn", "fail"}; ``run()`` prints a report and returns a process exit
code (0 = no failures).  Under ``device="cpu"`` the card's checks warn
that there is no card; they do not run on the CPU in its place.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, List, Tuple

import torch

from ncf_tpu_torch.utils.device import DeviceLike, resolve_device

Check = Tuple[str, str, str]   # (name, status, message)

# every kernel is compiled for sm_90a (ops/_kernels.py NVCC_FLAGS)
KERNEL_CAPABILITY = (9, 0)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TB"


def check_devices(device: DeviceLike = None) -> Check:
    dev = resolve_device(device)
    versions = f"torch {torch.__version__}, CUDA {torch.version.cuda}"
    if dev.type != "cuda":
        return ("devices", "warn", f"no card: the kernels are neither "
                f"built nor run (device={dev}; {versions})")
    n = torch.cuda.device_count()
    cards = [(torch.cuda.get_device_name(i),
              torch.cuda.get_device_capability(i)) for i in range(n)]
    names = sorted({f"{name} (sm_{cc[0]}{cc[1]})" for name, cc in cards})
    msg = f"{n}x {' / '.join(names)}; {versions}"
    wrong = [name for name, cc in cards if tuple(cc) != KERNEL_CAPABILITY]
    if wrong:
        return ("devices", "fail", msg + " — the kernels are built for "
                "sm_90a only and do not run on " + ", ".join(wrong))
    return ("devices", "ok", msg)


def check_compile_smoke(device: DeviceLike = None) -> Check:
    """Find ``nvcc``, build every ``csrc/*.cu`` (a warm ``_build/``
    cache reuses them), then launch B7 on a seeded table and hold it bit
    for bit to its plain version."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ("compile", "warn",
                "no card: the CUDA kernels are not built (device=cpu)")
    try:
        from ncf_tpu_torch.ops import _kernels
        from ncf_tpu_torch.ops.gather import gather_rows, gather_rows_ref

        nvcc = _kernels._nvcc()
        secs = _kernels.build_all()
        g = torch.Generator().manual_seed(0)
        table = torch.randn(1000, 64, generator=g).to(dev)
        ids = torch.randint(0, 1000, (4096,), generator=g,
                            dtype=torch.int32).to(dev)
        t0 = time.perf_counter()
        out = gather_rows(table, ids)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        equal = torch.equal(out, gather_rows_ref(table, ids))
    except Exception as e:
        return ("compile", "fail", f"kernel build or launch failed: {e}")
    msg = (f"{nvcc}: {len(_kernels.SOURCES)} sources built in {secs:.2f}s; "
           f"B7 gather_rows [1000x64] f32 x 4096 ids in {ms:.2f} ms")
    if not equal:
        return ("compile", "fail", msg + " DIFFERS from its plain version "
                "table[ids]")
    return ("compile", "ok", msg + ", equal to its plain version "
            "table[ids] bit for bit")


def estimate_train_hbm(cfg) -> int:
    """Rough peak-memory estimate for a training step of the configured
    model: fused tables + dense params, optimizer state (adam = 2 slots;
    rowwise_adagrad = 1 scalar/row), gradients, and the dominant batch
    activations.  Deliberately conservative (f32 accounting).  It reads
    the vocabulary as the config writes it (a synthetic config's model is
    sized from its log only at train time)."""
    m, t = cfg.model, cfg.train
    d2 = m.mf_dim + m.mlp_dim
    table_rows = m.num_users + m.num_items
    table = table_rows * d2 * 4
    dense = (sum(a * b for a, b in zip(
        [m.mlp_dim + (m.mlp_dim if m.use_sequence else 0) + m.temporal_dim]
        + list(m.mlp_hidden_dims[:-1]), m.mlp_hidden_dims))
        + 4 * m.mlp_dim * m.mlp_dim + m.temporal_dim * 64) * 4
    params = table + dense
    if t.embedding_optimizer == "rowwise_adagrad":
        opt = table_rows * 4 + 2 * dense * 2 + params  # row slots + adam on dense + grads
    else:
        opt = 3 * params                               # m + v + grads
    S = 1 + m.negative_samples
    rows = t.batch_size * S * (1 + (m.history_len if m.use_sequence else 0))
    acts = rows * (d2 + sum(m.mlp_hidden_dims)) * 2 * 3   # bf16, fwd+bwd
    return int(params + opt + acts)


def check_hbm_budget(cfg, device: DeviceLike = None) -> Check:
    dev = resolve_device(device)
    est = estimate_train_hbm(cfg)
    if dev.type != "cuda":
        return ("hbm", "warn",
                f"estimated train footprint {_fmt_bytes(est)} ({est} B); no "
                "device memory limit (device=cpu)")
    limit = torch.cuda.get_device_properties(dev).total_memory
    frac = est / limit
    msg = (f"estimated train footprint {_fmt_bytes(est)} ({est} B) of "
           f"{_fmt_bytes(limit)} ({frac:.0%}) on "
           f"{torch.cuda.get_device_name(dev)}")
    if frac > 1.0:
        return ("hbm", "fail", msg + " — enable "
                "train.sparse_table_update with rowwise_adagrad or shard "
                "the tables over a mesh of ranks "
                "(configs/advanced_ncf_ml25m_sharded.yaml)")
    if frac > 0.7:
        return ("hbm", "warn", msg)
    return ("hbm", "ok", msg)


def check_mesh(cfg, device: DeviceLike = None) -> Check:
    """A device of the port's mesh is a rank of the process group
    (``parallel/mesh.py``): ``dcn x ici`` must equal the ranks running."""
    from ncf_tpu_torch.parallel import multihost

    mesh = cfg.mesh
    if isinstance(mesh.enable, bool):            # YAML on/off coercion
        mesh.enable = "on" if mesh.enable else "off"
    if mesh.enable == "off":
        return ("mesh", "ok", "single-device config (mesh.enable=off)")
    dev = resolve_device(device)
    have = multihost.process_count()
    dcn = (mesh.dcn_axis if mesh.dcn_axis != -1
           else multihost.mesh_shape_for_hosts()[0])
    ici = mesh.ici_axis if mesh.ici_axis > 0 else have // dcn   # make_mesh
    want = dcn * ici
    shape = f"(dcn={dcn}, ici={ici})"
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or want)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    _, rule = multihost.choose_backend(dev.type, local, cards)
    if want != have and (mesh.enable == "on" or have > 1):
        return ("mesh", "fail",
                f"mesh {shape} needs {want} ranks, {have} running (start "
                f"them with python -m torch.distributed.run "
                f"--nproc-per-node {want} -m ncf_tpu_torch.cli ...; {rule})")
    if want != have:
        return ("mesh", "warn",
                f"mesh {shape} needs {want} ranks, {have} running — one "
                "process: no mesh (mesh.enable=auto)")
    if have <= 1 and mesh.enable == "auto":
        return ("mesh", "ok", f"mesh {shape}: one process, no mesh "
                "(mesh.enable=auto)")
    return ("mesh", "ok", f"mesh {shape} fits {have} rank(s); {rule}")


def check_artifact_store(cfg) -> Check:
    d = cfg.train.checkpoint_dir or "checkpoints"
    try:
        os.makedirs(d, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=d, prefix=".doctor_", mode="w") as f:
            f.write("ok")
        return ("artifact_store", "ok", f"checkpoint dir writable: {d}")
    except OSError as e:
        return ("artifact_store", "fail",
                f"checkpoint dir {d!r} not writable: {e}")


def check_native_loader() -> Check:
    try:
        from ncf_tpu_torch import native
        lib = native.get_lib()
    except Exception as e:                                # pragma: no cover
        return ("native", "fail", f"native module import failed: {e}")
    if lib is None:
        return ("native", "warn",
                "libncf_native.so unavailable (no toolchain?); the NumPy "
                "fallback sampler is active — correct but slower "
                "host-side sampling")
    return ("native", "ok", "C++ alias sampler/CSR loader loaded")


def check_redis(cfg) -> Check:
    url = getattr(cfg.serving, "redis_url", "") or os.environ.get(
        "NCF_REDIS_URL", "")
    if not url:
        return ("redis", "ok",
                "no redis configured; in-process TTL cache active "
                "(serving works without it)")
    try:
        import redis  # optional dependency

        client = redis.from_url(url, socket_connect_timeout=2)
        client.ping()
        return ("redis", "ok", f"redis reachable at {url}")
    except Exception as e:
        return ("redis", "warn",
                f"redis configured ({url}) but unreachable: {e} — "
                "FeatureCache will fall back to the in-process cache")


def check_config(cfg) -> Check:
    try:
        cfg.validate()
        return ("config", "ok", "config invariants hold")
    except ValueError as e:
        return ("config", "fail", str(e))


def run(cfg, out=print, device: DeviceLike = None) -> int:
    """Run all checks, print a report, return an exit code.  ``device``
    (default ``cuda``) raises without a card unless ``"cpu"``."""
    dev = resolve_device(device)
    checks: List[Callable[[], Check]] = [
        lambda: check_config(cfg),
        lambda: check_devices(dev),
        lambda: check_compile_smoke(dev),
        lambda: check_hbm_budget(cfg, dev),
        lambda: check_mesh(cfg, dev),
        lambda: check_artifact_store(cfg),
        check_native_loader,
        lambda: check_redis(cfg),
    ]
    icons = {"ok": "✓", "warn": "!", "fail": "✗"}
    worst = 0
    for fn in checks:
        try:
            name, status, msg = fn()
        except Exception as e:                            # pragma: no cover
            name, status, msg = (getattr(fn, "__name__", "check"),
                                 "fail", f"check crashed: {e}")
        out(f"{icons[status]} {name:<15} {msg}")
        worst = max(worst, {"ok": 0, "warn": 0, "fail": 1}[status])
    out("doctor: " + ("all checks passed" if worst == 0
                      else "FAILURES found — see above"))
    return worst
