"""One ``Trainer.train_step`` on several processes equals the one-process step.

The ranks are processes on the CPU over gloo (``torch_parallel_utils.spawn``).
Each case takes a tiny fp32 SegOFA without dropout, the same global batch
of 4 rows and one step; each rank steps on its rows
(``parallel.mesh.batch_rows``) and the result is gathered whole
(``Trainer.state_dict``).  Against the one-process step on the whole batch:
loss, monitoring loss and gnorm within 1e-5 relative, the confusion areas
equal, and every parameter after the update within 1e-5 relative
(||p_mp − p_1p|| ≤ 1e-5·||p_1p||); the update itself within 1e-4 relative
beyond the fp32 resolution of the parameter (||Δ_mp − Δ_1p|| ≤
1e-4·||Δ_1p|| + 1e-7·||p_1p||).  Both runs start from the same perturbed
weights and seeded optimizer moments, loaded whole and cut to each rank's
parts (``Trainer.load_state_dict``): with every parameter off zero and the
second moments above the gradients' rounding noise, the update is smooth
in the gradient.  The cases: data 2, fsdp 2, data 2 + zero1, tensor 2 under Adam; Lamb
and Adafactor (whose updates reduce over whole tensors) under fsdp 2 and
zero1; save-attn activation checkpointing under fsdp 2; prefix tuning
(4-D all-layer bias packs) under tensor 2; and fsdp 2 x tensor 2 on four
processes.  Both process counts are spawned once for the file.
"""

import numpy as np
import pytest

from torch_parallel_utils import class_table, global_batch, rows, spawn, tiny_config

CASES = {
    "data2-adam": dict(world=2, dist=dict(data_parallel=2)),
    "fsdp2-adam": dict(world=2, dist=dict(fsdp=2)),
    "fsdp2-lamb": dict(world=2, dist=dict(fsdp=2), opt="lamb"),
    "fsdp2-adafactor": dict(world=2, dist=dict(fsdp=2), opt="adafactor"),
    "data2-zero1-adam": dict(world=2, dist=dict(data_parallel=2, zero1=True)),
    "data2-zero1-lamb": dict(world=2, dist=dict(data_parallel=2, zero1=True), opt="lamb"),
    "data2-zero1-adafactor": dict(world=2, dist=dict(data_parallel=2, zero1=True),
                                  opt="adafactor"),
    "tensor2-adam": dict(world=2, dist=dict(tensor_parallel=2)),
    "fsdp2-save-attn": dict(world=2, dist=dict(fsdp=2),
                            model=dict(checkpoint_activations=True, remat_policy="save-attn")),
    "tensor2-prefix": dict(world=2, dist=dict(tensor_parallel=2),
                           model=dict(encoder_prompt=True, decoder_prompt=True,
                                      encoder_prompt_length=4, decoder_prompt_length=3)),
    "fsdp2xtensor2-adam": dict(world=4, dist=dict(fsdp=2, tensor_parallel=2)),
}
BATCH = 4


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def seeded_state(node, rng, first=False):
    """The optimizer state with count 3 and seeded moments: first moments
    N(0, 1e-3), second moments U(1e-4, 1e-2).  With the second moments well
    above the gradients' rounding noise the update is smooth in the
    gradient, so the parameters measure the step and not the sign of
    noise (a key bias, whose gradient is zero up to rounding, would
    otherwise move by ±lr on either side)."""
    import torch

    out = {}
    for k, v in node.items():
        if k == "count":
            out[k] = 3
        elif isinstance(v, dict):
            out[k] = seeded_state(v, rng, first or k == "mu")
        elif isinstance(v, torch.Tensor):
            vals = rng.normal(0, 1e-3, v.shape) if first else rng.uniform(1e-4, 1e-2, v.shape)
            out[k] = torch.as_tensor(vals, dtype=v.dtype)
        else:
            out[k] = v
    return out


def _run_case(case):
    import torch

    from ifseg_torch.config import DistributedConfig
    from ifseg_torch.parallel.mesh import batch_rows, mesh_from_config
    from ifseg_torch.train.trainer import Trainer

    def build(dist_cfg, mesh=None):
        cfg = tiny_config(**case.get("model", {}))
        cfg.optimization.optimizer = case.get("opt", "adam")
        cfg.distributed = dist_cfg
        tokens, lengths = class_table()
        return Trainer(cfg, tokens, lengths, total_num_updates=10, device="cpu",
                       mesh=mesh).init_state()

    batch = global_batch(3, BATCH)
    ref = build(DistributedConfig())
    # every parameter off zero (the key biases start at 0 and their
    # gradient is rounding noise), then the same whole state into both
    rng = np.random.default_rng(5)
    weights = {k: v + torch.as_tensor(rng.normal(0, 0.02, v.shape), dtype=v.dtype)
               if v.is_floating_point() else v for k, v in ref.state_dict()["model"].items()}
    state = seeded_state(ref.optimizer.state_dict(), rng)
    ref.load_state_dict({"model": weights, "optimizer": state})
    before = {k: v.clone() for k, v in ref.state_dict()["model"].items()}
    ref_logs = ref.train_step(batch)
    ref_after = ref.state_dict()["model"]

    dist_cfg = DistributedConfig(**case["dist"])
    mesh = mesh_from_config(dist_cfg, "cpu")
    tr = build(dist_cfg, mesh)
    tr.load_state_dict({"model": weights, "optimizer": state})  # cut to each rank's parts
    logs = tr.train_step(rows(batch, batch_rows(BATCH, mesh)))
    after = tr.state_dict()["model"]
    names = [n for n, _ in ref.model.named_parameters()]
    out = {k: (float(logs[k]), float(ref_logs[k])) for k in ("loss", "gnorm", "nll_loss")}
    out["areas_equal"] = all(
        torch.equal(logs[k], ref_logs[k]) for k in ref_logs if k.startswith("area"))
    out["param_rel"] = max(_rel(after[n].numpy(), ref_after[n].numpy()) for n in names)
    upd = []
    for n in names:
        d_ref = (ref_after[n] - before[n]).numpy()
        d_mp = (after[n] - before[n]).numpy()
        # beyond 1e-4 of the update, what the fp32 parameter can hold
        scale = 1e-4 * np.linalg.norm(d_ref) + 1e-7 * np.linalg.norm(ref_after[n].numpy())
        upd.append(float(np.linalg.norm(d_mp - d_ref) / scale) if scale > 0 else 0.0)
    out["update_rel"] = max(upd)
    out["n_updated"] = sum(bool(np.any((ref_after[n] - before[n]).numpy())) for n in names)
    return out


def _worker(rank, world, names):
    return {name: _run_case(CASES[name]) for name in names}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = {}
    for world in (2, 4):
        names = [n for n, c in CASES.items() if c["world"] == world]
        per_rank = spawn(world, _worker, (names,), tmp_path_factory.mktemp(f"w{world}"))
        for r, res in enumerate(per_rank):
            for name, v in res.items():
                out.setdefault(name, []).append(v)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_process_step_equals_one_process(results, name):
    for res in results[name]:  # every rank returns the global step's logs
        for k in ("loss", "gnorm", "nll_loss"):
            got, want = res[k]
            assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
        assert res["areas_equal"]
        assert res["param_rel"] <= 1e-5, res["param_rel"]
        assert res["update_rel"] <= 1.0, res["update_rel"]
        assert res["n_updated"] >= 2
