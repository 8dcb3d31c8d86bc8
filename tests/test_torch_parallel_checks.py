"""The cross-process sanitizers and reductions of the port on two processes
(gloo on the CPU, ``torch_parallel_utils.spawn``, once for the file):

- ``check_grad_norms`` passes on equal norms and fails when one rank's
  differs;
- ``check_param_sync`` on the trainer's fingerprint passes on synced ranks,
  data parallel and fully sharded, and fails when one rank's copy of a
  parameter that both hold whole is nudged (a fully sharded part exists on
  one rank only: the fingerprint sums it over the group, as the JAX
  package's sums a sharded leaf);
- ``cross_process_sum`` over 2 ranks is the JAX semantics: the per-key sum
  of the numeric entries, the other entries as they were;
- ``Heartbeat`` fires after its timeout without beats, and not while it
  gets them.
"""

import time

import numpy as np
import pytest

from torch_parallel_utils import class_table, spawn, tiny_config


def _trainer(dist_kw):
    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.parallel.mesh import mesh_from_config
    from ifseg_torch.train.trainer import Trainer

    cfg = tiny_config()
    cfg.distributed = DistributedConfig(**dist_kw)
    tokens, lengths = class_table()
    return Trainer(cfg, tokens, lengths, device="cpu",
                   mesh=mesh_from_config(cfg.distributed, "cpu")).init_state()


def _worker(rank, world):
    import torch

    from ifseg_torch.utils.metrics import cross_process_sum
    from ifseg_torch.utils.reliability import check_grad_norms, check_param_sync

    out = {"grad_same": check_grad_norms(2.5),
           "grad_differ": check_grad_norms(2.5 + rank)}
    for kw in (dict(data_parallel=2), dict(fsdp=2)):
        tr = _trainer(kw)
        key = "fsdp" if "fsdp" in kw else "data"
        out[f"sync_{key}"] = check_param_sync(tr.fingerprint())
        if rank == 1:  # a LayerNorm scale: whole on both ranks, fully sharded or not
            with torch.no_grad():
                dict(tr.model.named_parameters())["encoder.layer_norm.weight"].add_(0.5)
        out[f"nudged_{key}"] = check_param_sync(tr.fingerprint())
    out["sum"] = cross_process_sum({
        "n": rank + 1, "x": 0.5 * rank, "areas": np.arange(3, dtype=np.float32) * (rank + 1),
        "t": torch.tensor([1.0, rank]), "tag": "valid"})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return spawn(2, _worker, (), tmp_path_factory.mktemp("checks"))


def test_check_grad_norms(results):
    assert all(r["grad_same"] for r in results)
    assert not any(r["grad_differ"] for r in results)


@pytest.mark.parametrize("kind", ["data", "fsdp"])
def test_check_param_sync(results, kind):
    assert all(r[f"sync_{kind}"] for r in results)
    assert not any(r[f"nudged_{kind}"] for r in results)


def test_cross_process_sum_is_the_per_key_sum(results):
    for r in results:
        s = r["sum"]
        assert set(s) == {"n", "x", "areas", "t", "tag"}
        assert float(s["n"]) == 3.0 and float(s["x"]) == 0.5
        np.testing.assert_array_equal(s["areas"], np.arange(3) * 3.0)
        np.testing.assert_array_equal(s["t"], [2.0, 1.0])
        assert s["tag"] == "valid"


def test_cross_process_sum_is_the_identity_on_one_process():
    from ifseg_torch.utils.metrics import cross_process_sum

    logs = {"n": 1, "areas": np.ones(2)}
    assert cross_process_sum(logs) is logs


def test_heartbeat_fires_after_its_timeout():
    from ifseg_torch.utils.reliability import Heartbeat

    quiet = Heartbeat(timeout=0.2).start()
    time.sleep(0.6)
    quiet.stop()
    assert quiet.fired >= 1
    busy = Heartbeat(timeout=0.4).start()
    for _ in range(8):
        busy.beat()
        time.sleep(0.05)
    busy.stop()
    assert busy.fired == 0
