"""The port's launchers on the CPU, and builds that run at once.

- ``python -m ncf_tpu_torch.parallel.launch``: 2 ranks of ``dense``
  training agree on the loss; 4 ranks (``(2, 2)``) of ``sparse_seq`` save
  a sharded checkpoint, then one process re-runs the stream (losses
  within rtol 1e-5 of the 4-rank run's), restores the checkpoint across
  the topology change, consolidates it bit for bit and serves the same
  top-k from both restores (the checks of ``scripts/
  launch_multiprocess.py``).
- ``dryrun_multichip(4)`` prints every token of the reference's dryrun.
- Two processes loading the native library at once into an empty build
  directory: exactly one compiles, both load it.
- ``multihost.destroy`` on 2 gloo ranks of a ``(1, 2)`` mesh leaves no
  process group alive, though the mesh is: a group handle that outlives
  ``destroy_process_group`` is torn down at interpreter exit, where gloo
  now and then aborts the rank (``terminate called without an active
  exception``, exit -6), which failed a two-rank test now and then.
- ``initialize_distributed`` writes a rank's backend line in one write,
  so ranks sharing ``torch.distributed.run``'s pipe under unbuffered
  output do not run their lines into one.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from ncf_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = ("sharded_tables=2", "all_to_all=ok", "sparse_sharded_seq",
          "sharded_eval", "sharded_topk=ok", "sharded_topk_prepared=ok",
          "sharded_topk_int8=ok", "fused_tower_mesh=ok", "sequence_mesh=ok")


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "ncf_tpu_torch.parallel.launch", *args],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)


def test_two_rank_launch():
    out = _launch("--ici", "2", "--steps", "2", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "launch: OK" in out.stdout
    assert "[worker 0/2] ok" in out.stdout
    assert "[worker 1/2] ok" in out.stdout
    assert "backend gloo on cpu" in out.stdout


def test_sparse_seq_launch_checkpoint_and_single_process_check(tmp_path):
    ckpt, js = str(tmp_path / "ckpt"), str(tmp_path / "mp.json")
    out = _launch("--mode", "sparse_seq", "--dcn", "2", "--ici", "2",
                  "--steps", "3", "--checkpoint-dir", ckpt, "--out-json", js,
                  "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "launch: OK" in out.stdout
    chk = _launch("--single-process", "--mode", "sparse_seq", "--steps", "3",
                  "--checkpoint-dir", ckpt, "--out-json", js, "--device",
                  "cpu")
    assert chk.returncode == 0, chk.stdout + chk.stderr
    for line in ("trajectory matches the 4-rank run",
                 "restored across the topology change",
                 "consolidation round-trips bit-exact",
                 "serves top-k (sharded == consolidated, exact)",
                 "single_process: OK"):
        assert line in chk.stdout, chk.stdout


def test_dryrun_multichip_prints_every_token():
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip(n=4): ok")
    for tok in TOKENS:
        assert tok in line, (tok, line)


def test_multihost_config_builds_its_mesh_shape(tmp_path):
    """``configs/advanced_ncf_100m_multihost.yaml`` needs several hosts at
    its own size; here it loads and builds its ``(hosts, ranks a host)``
    mesh on 4 ranks posing as 2 hosts of 2, and ``(1, 1)`` alone."""
    from ncf_tpu_torch.parallel import workers
    from ncf_tpu_torch.utils.config import Config

    path = os.path.join(ROOT, "configs", "advanced_ncf_100m_multihost.yaml")
    cfg = Config.from_yaml(path)
    assert cfg.data.synthetic_users == 100_000_000
    assert cfg.build_mesh() is None                  # enable: off
    cfg.mesh.enable = "on"
    assert cfg.build_mesh().shape == {"dcn": 1, "ici": 1}
    io = str(tmp_path / "io")
    workers.save_inputs(io, {}, {"config_path": path})
    workers.run("mesh_shape", 4, io, device="cpu", local_world=2)
    for r in range(4):
        _, got = workers.load_outputs(io, r)
        assert got["shape"] == {"dcn": 2, "ici": 2}
        assert (got["dcn_index"], got["ici_index"]) == divmod(r, 2)


def test_concurrent_native_builds_compile_once(tmp_path):
    code = textwrap.dedent(f"""
        import os
        import ncf_tpu_torch.native as native
        native.BUILD_DIR = {str(tmp_path)!r}
        native._SO = os.path.join(native.BUILD_DIR, "libncf_native.so")
        ok = native.available()
        print("built" if native.built_here else "reused", ok)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    said = sorted(o[0].split()[0] for o in outs)
    if any("False" in o[0] for o in outs):
        pytest.skip("no C++ compiler here")
    assert said == ["built", "reused"], outs
    assert os.path.exists(tmp_path / "libncf_native.so")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_destroy_leaves_no_process_group_alive(tmp_path):
    code = textwrap.dedent(f"""
        import gc, sys, weakref
        import torch
        import torch.distributed.distributed_c10d as c10d
        from ncf_tpu_torch.parallel import multihost
        from ncf_tpu_torch.parallel.mesh import ICI_AXIS, make_mesh

        rank = int(sys.argv[1])
        multihost.initialize_distributed(
            init_method="file://{tmp_path}/store", world_size=2, rank=rank,
            device="cpu", timeout_s=60)
        mesh = make_mesh(dcn=1, ici=2)
        x = torch.arange(4.0) + rank
        got = mesh.all_to_all(mesh.all_reduce(x.clone()), ICI_AXIS)
        assert got.tolist() == ([1.0, 3.0] * 2 if rank == 0 else [5.0, 7.0] * 2)
        groups = [weakref.ref(g) for g in list(c10d._world.pg_map)]
        assert len(groups) >= 2                  # the world and the ici group
        multihost.destroy()                      # the mesh is still alive
        gc.collect()
        print("alive", sum(r() is not None for r in groups), len(groups))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for out, _ in outs:
        alive = out.split("alive")[-1].split()
        assert alive[0] == "0", (f"{alive[0]} of {alive[1]} process groups "
                                 f"outlive multihost.destroy()", outs)


def test_backend_line_is_one_write(tmp_path):
    # print() writes the text and the newline apart; with two ranks on
    # one unbuffered pipe that let their lines run together
    child = textwrap.dedent(f"""
        import json, sys
        from ncf_tpu_torch.parallel import multihost

        class Recorder:
            def __init__(self):
                self.writes = []

            def write(self, s):
                self.writes.append(s)
                return len(s)

            def flush(self):
                pass

        rec, real = Recorder(), sys.stdout
        sys.stdout = rec
        multihost.initialize_distributed(
            world_size=1, rank=0, device="cpu",
            init_method="file://{tmp_path / 'store'}")
        sys.stdout = real
        multihost.destroy()
        print(json.dumps(rec.writes))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1")
    run = subprocess.run([sys.executable, "-c", child], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    writes = json.loads(run.stdout.splitlines()[-1])
    lines = [w for w in writes if "backend" in w]
    assert len(lines) == 1 and lines[0].startswith("[rank 0/1] backend gloo")
    assert lines[0].endswith("\n") and lines[0].count("\n") == 1, writes
