"""The port's ``parallel/`` (``torch.distributed`` process groups and a
(data, model) ``DeviceMesh``) and the sharded ``eval_nolearned`` sweep, on
CPU processes joined by gloo.

One 4-rank run on a 2 x 2 mesh (``tests/torch_parallel_worker.py``) holds
``register_sharded`` bit for bit to ``register_batch`` and
``neco_train_step_sharded`` to one process's step over the whole batch
(1e-5 relative); its metric sums and its sharded 1-NN minimum are held here
to the JAX package's on the 8 virtual CPU devices of ``tests/conftest.py``
(1e-5) and to the dense minimum. One 2-rank sweep of
``cli/eval_nolearned.py`` writes ``.p0`` / ``.p1`` ledgers whose rows are
bit-equal to a one-process sweep's.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import yaml

from deformationpyramid_tpu.parallel import batched as jbatched
from deformationpyramid_tpu.parallel import mesh as jmesh
from deformationpyramid_tpu_torch.cli import eval_nolearned as teval
from deformationpyramid_tpu_torch.data.synthetic import write_4dmatch_suite
from deformationpyramid_tpu_torch.parallel import mesh as tmesh

import torch_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv, world: int, timeout: int = 600) -> None:
    """Start ``world`` ranks of ``argv`` with torchrun's variables and wait
    for all of them."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        env.pop("PYTEST_CURRENT_TEST", None)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-2000:] + err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


def test_initialize_distributed_world_of_one(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tmesh.dist, "init_process_group", rec)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.initialize_distributed("cpu") is False
    assert rec.calls == []


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_initialize_distributed_wires_torchrun_variables(monkeypatch,
                                                         device):
    rec, cards = _Recorder(), []
    monkeypatch.setattr(tmesh.dist, "init_process_group", rec)
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tmesh.torch.cuda, "set_device", cards.append)
    for k, v in dict(WORLD_SIZE="4", RANK="3", LOCAL_RANK="1",
                     MASTER_ADDR="10.0.0.1", MASTER_PORT="1234").items():
        monkeypatch.setenv(k, v)
    assert tmesh.initialize_distributed(device) is True
    backend = "nccl" if device == "cuda" else "gloo"
    assert rec.calls == [((backend,), dict(
        init_method="tcp://10.0.0.1:1234", world_size=4, rank=3))]
    assert cards == ([1] if device == "cuda" else [])
    assert tmesh.local_device(device) == (
        torch.device("cuda", 1) if device == "cuda" else torch.device("cpu"))


def test_local_device():
    assert tmesh.local_device("cpu") == torch.device("cpu")
    assert tmesh.local_device("cuda:3") == torch.device("cuda", 3)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    _launch([os.path.join(REPO, "tests", "torch_parallel_worker.py"),
             str(out), "2", "2"], world=4)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def test_four_ranks_mesh_and_register_sharded(four_ranks):
    # rank r at (r // n_model, r % n_model); register_sharded's warps (held
    # bit-equal to register_batch on each rank) are the same on every rank
    assert [tuple(r["coords"]) for r in four_ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four_ranks[1:]:
        assert np.array_equal(r["warped"], four_ranks[0]["warped"])
    assert np.isfinite(four_ranks[0]["warped"]).all()


def test_four_ranks_metric_sums_equal_jax(four_ranks):
    flow, gt, mask = worker.metric_inputs()
    jsums = jbatched.aggregate_metrics_sharded(jmesh.make_mesh())(
        jnp.array(flow), jnp.array(gt), jnp.array(mask))
    for r in four_ranks:
        for k, v in jsums.items():
            got = float(r[f"sum_{k}"])
            assert abs(got - float(v)) <= 1e-5 * max(abs(float(v)), 1.0), k
    assert float(four_ranks[0]["sum_count"]) == mask.sum()


def test_four_ranks_nn_min_equals_dense_and_jax(four_ranks):
    x, y = worker.nn_inputs()
    dense = ((x[:, None] - y[None]) ** 2).sum(-1).min(1)
    jgot = np.asarray(jbatched.sharded_nn_min(
        jmesh.make_mesh(n_data=1, n_model=8))(jnp.array(x), jnp.array(y)))
    for r in four_ranks:
        assert np.abs(r["nn_min"] - dense).max() <= 1e-5
        assert np.abs(r["nn_min"] - jgot).max() <= 1e-5


def test_four_ranks_neco_step_equals_one_process(four_ranks):
    for r in four_ranks:
        loss, ref_loss = r["neco_loss"]
        assert np.isfinite(loss) and abs(loss - ref_loss) <= 1e-5 * abs(
            ref_loss)
        assert float(r["neco_rel_err"]) <= 1e-5
        assert float(r["neco_moved"]) > 0.0


def test_sharded_functions_refuse_an_uneven_split():
    """B (or M) must divide by its axis, as in the JAX package."""
    class Mesh:
        def __getitem__(self, axis):
            return self

        def size(self):
            return 3

        def get_local_rank(self, axis):
            return 0

    from deformationpyramid_tpu_torch.parallel import batched
    with pytest.raises(ValueError, match="do not divide"):
        batched.sharded_nn_min(Mesh())(torch.zeros(4, 3), torch.zeros(8, 3))
    with pytest.raises(ValueError, match="do not divide"):
        batched.register_sharded(Mesh(), worker.TINY)(
            [0, 1], torch.zeros(2, 8, 3), torch.zeros(2, 8, 3))


def test_two_rank_sweep_rows_equal_one_process(tmp_path):
    root = str(tmp_path / "data")
    write_4dmatch_suite(root, "4DMatch-F", n_pairs=2,
                        size_clusters=(150,), seed=2)
    cfg = tmp_path / "ndp.yaml"
    cfg.write_text(yaml.safe_dump(dict(
        deformation_model="NDP", data_root=root, samples=60, m=2, width=16,
        iters=4)))
    argv = ["--config", str(cfg), "--splits", "4DMatch-F", "--device", "cpu"]
    _launch(["-m", "deformationpyramid_tpu_torch.cli.eval_nolearned", *argv,
             "--log-dir", str(tmp_path / "two")], world=2)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        teval.main([*argv, "--log-dir", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(n)

    def rows(path):
        return [json.loads(l) for l in path.read_text().splitlines()]

    one = rows(tmp_path / "one" / "4DMatch-F.pairs.jsonl")
    assert len(one) == 2 and not list((tmp_path / "one").glob("*.p0.*"))
    for r in range(2):
        got = rows(tmp_path / "two" / f"4DMatch-F.p{r}.pairs.jsonl")
        assert got == [one[r]]          # rank r takes pairs r, r + 2, ...
        assert (tmp_path / "two" / f"4DMatch-F.p{r}.done").read_text() \
            == one[r]["name"] + "\n"
        assert (tmp_path / "two" / f"4DMatch-F.p{r}.log").exists()
    assert not (tmp_path / "two" / "4DMatch-F.pairs.jsonl").exists()
