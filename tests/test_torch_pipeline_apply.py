"""``pipeline_apply`` — GPipe over ``torch.distributed`` — against the JAX
package's ``shard_map`` schedule, on the CPU.

Four ``gloo`` ranks, each its own process, meet on a ``FileStore`` under
``tmp_path``; the JAX package runs ``tests/test_pipeline.py``'s inputs
(P 4, M 6, B 2, D 16, F 32, a tanh MLP stage, seed 0) on 4 forced CPU
devices in a subprocess. Every rank's result must lie within 1e-5 of the
reference's (fp32 products in another order), as must a world of one
against the sequential stage. The process group and every subprocess
have a timeout.
"""
import datetime
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed.pipeline import pipeline_apply
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TOL = 1e-5
TIMEOUT_S = 300
P_, M, B, D, F = 4, 6, 2, 16, 32


def _inputs():
    """``tests/test_pipeline.py``'s draws, in its order."""
    rng = np.random.default_rng(0)
    w1 = (rng.standard_normal((P_, D, F)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((P_, F, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, B, D)).astype(np.float32)
    return w1, w2, x


def _stage(p, a):
    return a + torch.tanh(a @ p["w1"]) @ p["w2"]


def _sequential(w1, w2, x):
    out = torch.from_numpy(x)
    for s in range(w1.shape[0]):
        out = _stage({"w1": torch.from_numpy(w1[s]),
                      "w2": torch.from_numpy(w2[s])}, out)
    return out.numpy()


_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.distributed.pipeline import pipeline_apply
    from repro.launch.mesh import _make_mesh
    mesh = _make_mesh((4,), ("pipe",))
    w1, w2, x = (np.load(sys.argv[1] + f"/{k}.npy") for k in ("w1", "w2", "x"))
    params = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}

    def stage(p, a):
        return a + jnp.tanh(a @ p["w1"]) @ p["w2"]

    got = jax.jit(lambda p, x: pipeline_apply(stage, p, x, mesh=mesh))(
        params, jnp.asarray(x))
    np.save(sys.argv[1] + "/jax.npy", np.asarray(got))
""")

_RANK_SCRIPT = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.distributed.pipeline import pipeline_apply
    torch.set_num_threads(1)
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    dist.init_process_group(
        "gloo", store=dist.FileStore(d + "/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        w1, w2, x = (torch.from_numpy(np.load(d + f"/{k}.npy"))
                     for k in ("w1", "w2", "x"))
        if rank > 0:      # only rank 0's copy of x is read
            x = torch.full_like(x, float("nan"))

        def stage(p, a):
            return a + torch.tanh(a @ p["w1"]) @ p["w2"]

        got = pipeline_apply(stage, {"w1": w1, "w2": w2}, x)
        np.save(d + f"/rank{rank}.npy", got.numpy())
    finally:
        dist.destroy_process_group()
""")


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def test_four_gloo_ranks_match_the_jax_pipeline(tmp_path):
    w1, w2, x = _inputs()
    for k, v in (("w1", w1), ("w2", w2), ("x", x)):
        np.save(tmp_path / f"{k}.npy", v)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(tmp_path), str(r),
         str(P_)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(P_)]
    ref = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(tmp_path)],
                         env=_env(), capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    errs = []
    try:
        for p in ranks:
            _, err = p.communicate(timeout=TIMEOUT_S)
            errs.append(err)
    finally:
        for p in ranks:
            p.kill()
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert [p.returncode for p in ranks] == [0] * P_, \
        "\n".join(e[-2000:] for e in errs)
    want = np.load(tmp_path / "jax.npy")
    seq = _sequential(w1, w2, x)
    assert np.abs(want - seq).max() < TOL
    report = {}
    for r in range(P_):
        got = np.load(tmp_path / f"rank{r}.npy")
        assert got.shape == (M, B, D) and np.isfinite(got).all()
        report[r] = float(np.abs(got - want).max())
    assert max(report.values()) < TOL, json.dumps(report)


def test_one_rank_is_the_sequential_stage(tmp_path):
    w1, w2, x = _inputs()
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got = pipeline_apply(_stage, {"w1": torch.from_numpy(w1[:1]),
                                      "w2": torch.from_numpy(w2[:1])},
                             torch.from_numpy(x))
    finally:
        dist.destroy_process_group()
    want = _sequential(w1[:1], w2[:1], x)
    assert np.abs(got.numpy() - want).max() < TOL
