"""The port's native-resolution ``Evaluator`` against the JAX package's (CPU,
fp32, the tiny model, ``BUCKET`` 64 and ``ROW_CHUNK`` 32 on both sides).

The JAX evaluator is fed fp32 PRE-NORMALIZED rows.  On its uint8 wire it
normalizes the whole zero-padded bucket, so its pad pixels become -mean/std,
while the stem's masking contract (and the port) wants a pad of exactly 0: on
uint8 rows a correct port differs from it.  The port's own uint8 wire is held
against its host-normalized fp32 run instead.

Tolerances: the confusion areas are pixel counts and must be equal; the
summed nll is an fp32 sum over ~1e4 pixels of logits that agree to ~1e-5:
1e-3 relative (1e-4 for the upsample alone, on identical logits).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ifseg_torch.eval.evaluator as tev
import ifseg_tpu.eval.evaluator as jev
from ifseg_torch.config import Config as TorchConfig
from ifseg_torch.data.segmentation_dataset import EvalSample as TorchSample
from ifseg_torch.data.segmentation_dataset import eval_mean_std
from ifseg_tpu.config import Config as JaxConfig
from ifseg_tpu.data.segmentation_dataset import EvalSample as JaxSample

from torch_port_utils import make_pair

AREAS = ("area_intersect", "area_pred_label", "area_label", "area_union")
POST = tuple(a + "_resnet_postprocess" for a in AREAS)


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    for mod in (tev, jev):
        monkeypatch.setattr(mod, "BUCKET", 64)
        monkeypatch.setattr(mod, "ROW_CHUNK", 32)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=0)


def _evaluators(pair, resnet_iters=0):
    jmodel, params, tmodel = pair
    jcfg = JaxConfig().replace(model=jmodel.cfg)
    tcfg = TorchConfig(model=tmodel.cfg)
    for cfg in (jcfg, tcfg):
        cfg.criterion.resnet_iters = resnet_iters
        cfg.criterion.resnet_topk = 2
    return jev.Evaluator(jcfg, jmodel), params, tev.Evaluator(tcfg, tmodel, device="cpu")


def _rows(shapes, seed, dtype=np.float32):
    """One dict of EvalSample fields per ((h, w), (H, W)); some target pixels
    are 'unknown' (= 5)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, ((h, w), (H, W)) in enumerate(shapes):
        img = (rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8) if dtype == np.uint8
               else rng.normal(size=(h, w, 3)).astype(np.float32))
        src = rng.integers(4, 100, size=(10,)).astype(np.int32)
        rows.append(dict(
            patch_image=img, src_tokens=src, bos_token=np.zeros((1,), np.int32),
            ori_semantic_seg=rng.integers(0, 6, size=(H, W)).astype(np.int32),
            ori_shape=(H, W, 3), id=i,
        ))
    return rows


class ListDS:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def get_eval_sample(self, i):
        return self.samples[i]


def _assert_same(got, want, keys=AREAS):
    for k in keys:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    np.testing.assert_allclose(got["nll_sum"], np.asarray(want["nll_sum"]), rtol=1e-3)
    assert float(got["nll_cnt"]) == float(want["nll_cnt"])
    np.testing.assert_allclose(got["nll_loss"], np.asarray(want["nll_loss"]), rtol=1e-3)
    np.testing.assert_allclose(got["loss"], got["nll_loss"])


def test_masked_label_propagation_matches_jax():
    rng = np.random.default_rng(0)
    b, l, c, f = 2, 24, 5, 16
    probs = rng.dirichlet(np.ones(c), size=(b, l)).astype(np.float32)
    feats = rng.normal(size=(b, l, f)).astype(np.float32)
    key_valid = np.arange(l) % 6 < 4
    probs[:, ~key_valid] = 0.0
    want = jev.masked_label_propagation(jnp.asarray(probs), jnp.asarray(feats),
                                        jnp.asarray(key_valid), 3, 4)
    got = tev.masked_label_propagation(torch.from_numpy(probs), torch.from_numpy(feats),
                                       torch.from_numpy(key_valid), 3, 4)
    # fp32 means of three values, possibly in another order: 1e-6
    np.testing.assert_allclose(got.numpy()[:, key_valid], np.asarray(want)[:, key_valid],
                               atol=1e-6)


def test_upsampled_areas_dyn_matches_jax():
    rng = np.random.default_rng(1)
    b, gh, gw, c, ho, wo, hp, wp = 3, 4, 8, 5, 128, 192, 3, 5
    grid = rng.normal(size=(b, gh, gw, c)).astype(np.float32) * 3
    ori = [(100, 160), (128, 150), (90, 192)]
    target = rng.integers(0, c + 1, size=(b, ho, wo)).astype(np.int32)
    uh = np.stack([tev.bilinear_matrix_dyn(gh, ho, oh, hp) for oh, _ in ori])
    uw = np.stack([tev.bilinear_matrix_dyn(gw, wo, ow, wp) for _, ow in ori])
    valid = np.zeros((b, ho, wo), bool)
    for i, (oh, ow) in enumerate(ori):
        valid[i, :oh, :ow] = True
    valid &= target != c
    chunks = ho // 32

    want_areas = [np.zeros(c, np.float32) for _ in range(4)]
    want_sum = want_cnt = 0.0
    for i in range(b):  # the JAX function runs one row at a time (under vmap)
        areas, (ce_sum, ce_cnt) = jev._upsampled_areas_dyn(
            jnp.asarray(grid[i: i + 1]), jnp.asarray(target[i: i + 1]),
            jnp.asarray(valid[i: i + 1]), c, jnp.asarray(uh[i]), jnp.asarray(uw[i]), chunks)
        want_areas = [a + np.asarray(x) for a, x in zip(want_areas, areas)]
        want_sum += float(ce_sum)
        want_cnt += float(ce_cnt)
    areas, (ce_sum, ce_cnt) = tev._upsampled_areas_dyn(
        torch.from_numpy(grid), torch.from_numpy(target).long(), torch.from_numpy(valid), c,
        torch.from_numpy(uh), torch.from_numpy(uw), chunks)
    for got, want in zip(areas, want_areas):
        assert np.array_equal(got.numpy(), want)
    assert float(ce_cnt) == want_cnt == valid.sum()
    np.testing.assert_allclose(float(ce_sum), want_sum, rtol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["fp32", "uint8"])
@pytest.mark.parametrize("n", [1, 3, 4])
def test_pack_group_equals_jax(pair, n, dtype):
    jevr, _, tevr = _evaluators(pair)
    shapes = [((48, 80), (96, 160)), ((47, 79), (100, 150)), ((45, 77), (90, 170)),
              ((48, 75), (130, 128))][:n]
    rows = _rows(shapes, seed=2, dtype=dtype)
    jkey, jargs = jevr._pack_group([JaxSample(**r) for r in rows])
    tkey, targs = tevr._pack_group([TorchSample(**r) for r in rows])
    assert tkey == jkey
    assert len(targs) == len(jargs) == 5
    for name, got, want in zip(("src", "image", "bos", "target", "meta"), targs, jargs):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name
    assert targs[1].shape[0] == 1 << (n - 1).bit_length()
    assert targs[3].dtype == np.uint8


def test_pack_group_refuses_mixed_ceil_extents(pair):
    _, _, tevr = _evaluators(pair)
    rows = _rows([((48, 80), (96, 160)), ((64, 80), (96, 160))], seed=3)
    with pytest.raises(AssertionError, match="ceil-16"):
        tevr._pack_group([TorchSample(**r) for r in rows])


@pytest.mark.parametrize(
    "shape", [((48, 80), (100, 160)), ((80, 48), (200, 120)), ((64, 64), (64, 64))],
    ids=["wide-gather", "tall-gather", "square"])
def test_eval_sample_matches_jax(pair, shape):
    jevr, params, tevr = _evaluators(pair, resnet_iters=2)
    row = _rows([shape], seed=4)[0]
    want = jevr.eval_sample(params, JaxSample(**row))
    got = tevr.eval_sample(TorchSample(**row))
    assert set(got) == set(want)
    _assert_same(got, want, AREAS + POST)
    H, W = shape[1]
    assert got["area_label"].sum() == (row["ori_semantic_seg"] != 5).sum()
    assert (got["area_intersect"] <= got["area_union"]).all()


def test_eval_sample_interpolation_branch_matches_jax(pair):
    """A valid grid larger than the pretraining grid (5x5 > 16 cells)."""
    jevr, params, tevr = _evaluators(pair)
    row = _rows([((80, 80), (150, 140))], seed=5)[0]
    _assert_same(tevr.eval_sample(TorchSample(**row)),
                 jevr.eval_sample(params, JaxSample(**row)))


def test_eval_dataset_matches_jax_and_per_sample(pair):
    """Mixed exact shapes: three share ceil-16 extents (3, 5) and one bucket
    -> one group of 3 padded to 4 rows; (64, 96) -> its own group."""
    jevr, params, tevr = _evaluators(pair, resnet_iters=1)
    shapes = [((48, 80), (96, 160)), ((47, 79), (100, 150)), ((64, 96), (128, 190)),
              ((45, 77), (90, 170))]
    rows = _rows(shapes, seed=6)
    jstats, tstats = {}, {}
    want = jevr.eval_dataset(params, ListDS([JaxSample(**r) for r in rows]), batch_size=4,
                             stats_out=jstats)
    tsamples = [TorchSample(**r) for r in rows]
    got = tevr.eval_dataset(ListDS(tsamples), batch_size=4, stats_out=tstats)
    assert tstats == jstats
    assert tstats["group_sizes"] == [3, 1] and len(got) == 2
    for g, w in zip(got, want):
        _assert_same(g, w, AREAS + POST)
    # batched equals per-sample, within the port
    per = [tevr.eval_sample(s) for s in tsamples]
    for k in AREAS + POST:
        assert np.array_equal(sum(g[k] for g in got), sum(p[k] for p in per)), k
    np.testing.assert_allclose(sum(g["nll_sum"] for g in got), sum(p["nll_sum"] for p in per),
                               rtol=1e-5)
    assert sum(g["nll_cnt"] for g in got) == sum(p["nll_cnt"] for p in per)


def test_eval_uint8_wire_matches_host_normalized(pair):
    """uint8 rows are normalized on the device and their pad zeroed again:
    the same answer as the host-normalized fp32 row (whose pad is 0)."""
    _, _, tevr = _evaluators(pair)
    row = _rows([((48, 75), (100, 160))], seed=7, dtype=np.uint8)[0]
    mean, std = eval_mean_std(tevr.cfg.task)
    norm = ((row["patch_image"].astype(np.float32) / 255.0 - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32))
    u8 = tevr.eval_sample(TorchSample(**row))
    f32 = tevr.eval_sample(TorchSample(**dict(row, patch_image=norm)))
    for k in AREAS:
        assert np.array_equal(u8[k], f32[k]), k
    np.testing.assert_allclose(u8["nll_sum"], f32["nll_sum"], rtol=1e-5)


def test_bucket_batching_forms_groups(monkeypatch):
    """Unique exact shapes, a handful of 256-pixel buckets: real batches
    form.  ``_run_group`` is stubbed: pure grouping logic."""
    monkeypatch.setattr(tev, "BUCKET", 256)
    rng = np.random.default_rng(0)
    shapes = [(480, 640), (640, 480), (427, 640), (480, 640), (375, 500),
              (640, 426), (481, 640), (333, 500)]
    samples = []
    for i in range(24):
        h, w = shapes[i % len(shapes)]
        samples.append(TorchSample(
            patch_image=np.zeros((h, w, 3), np.float32), src_tokens=np.zeros((12,), np.int32),
            bos_token=np.zeros((1,), np.int32),
            ori_semantic_seg=rng.integers(0, 3, size=(h, w)).astype(np.int32),
            ori_shape=(h, w), id=i))
    evr = tev.Evaluator(TorchConfig(), None, device="cpu")
    monkeypatch.setattr(evr, "_run_group", lambda group: {"n": torch.tensor(len(group))})
    stats = {}
    outs = evr.eval_dataset(ListDS(samples), batch_size=8, stats_out=stats)
    assert sum(stats["group_sizes"]) == 24
    assert max(stats["group_sizes"]) >= 4
    assert sum(int(o["n"]) for o in outs) == 24
    assert sum(stats["buckets"].values()) == 24


def test_memory_budget_caps_group_rows(monkeypatch):
    evr = tev.Evaluator(TorchConfig(), None, device="cpu")
    assert evr.mem_budget is None and evr._max_group_rows(512, 768) >= 1 << 20
    # the caller's budget, in bytes; absurdly small: one row at a time
    evr = tev.Evaluator(TorchConfig(), None, device="cpu", mem_budget=1.0)
    assert evr._max_group_rows(512, 768) == 1
    monkeypatch.setattr(evr, "_run_group", lambda group: {"n": torch.tensor(len(group))})
    samples = [TorchSample(np.zeros((48, 80, 3), np.float32), np.zeros((4,), np.int32),
                           np.zeros((1,), np.int32), np.zeros((64, 64), np.int32), None)] * 3
    stats = {}
    evr.eval_dataset(ListDS(samples), batch_size=4, stats_out=stats)
    assert stats["group_sizes"] == [1, 1, 1]
    evr = tev.Evaluator(TorchConfig(), None, device="cpu", mem_budget=1e12)
    wide, large = evr._max_group_rows(512, 768), evr._max_group_rows(1024, 1024)
    assert wide > large > 8
    # a group's rows are padded to the next power of two, so the cap is one
    assert wide & (wide - 1) == 0 and large & (large - 1) == 0


def test_producer_error_surfaces():
    class Broken(ListDS):
        def get_eval_sample(self, i):
            raise OSError("corrupt row")

    evr = tev.Evaluator(TorchConfig(), None, device="cpu")
    with pytest.raises(RuntimeError, match="preprocessing failed"):
        evr.eval_dataset(Broken([None, None]), batch_size=2)


def test_evaluator_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.Evaluator(TorchConfig(), None)
