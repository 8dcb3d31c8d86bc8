"""Turn a save directory of the JAX package's ``cli.train`` (orbax) into one
that the port's ``cli.train`` resumes from.

    python tools/orbax_to_torch.py JAX_SAVE_DIR PORT_SAVE_DIR <the run's cli.train flags>

The flags are the ones the JAX run was started with (its data, ``--arch``,
widths, optimizer and freeze flags, ``--ema-decay``, ...): from them the
abstract ``TrainState`` is built as the JAX ``Trainer.init_state`` builds it
(the model's parameters, the optimizer of ``build_optimizer``, the EMA copy),
on one CPU device, and every checkpoint that ``manifest.json`` names
(``epochs``, ``intervals``, ``best``, ``last``) is restored through the JAX
package's own ``CheckpointManager.load``, so the optax states come back
typed; a checkpoint saved by a mesh or by several processes reads whole onto
that one device.  Each is written in the port's layout through the port's
``CheckpointManager``:

  - ``model.pt``: ``state_dict_from_jax`` of the parameters;
  - ``ema.pt``: the EMA copy by parameter name, when the run keeps one;
  - ``optimizer.pt``: ``optimizer_state_from_jax`` for the port's optimizer
    of the same flags;
  - ``step.pt``: the JAX step.

No ``generator.pt``: JAX's ``fold_in`` key stream has no torch counterpart,
so the port's trainer, given a step without a generator, seeds its dropout
generator with ``--seed`` + step on whatever device it runs (the masks
differ from the JAX run's: ROADMAP.md C.3).  No ``plateau.pt``: the JAX CLI
keeps no plateau controller, so the port builds a fresh one, as the JAX CLI
does.  Each ``<name>.extra.json`` (epoch,
meters, iterator cursor: the same schema in both CLIs) is copied as it is,
and the manifest is taken over with its ``checkpoint_last`` and
``checkpoint_best`` links.

It refuses, and writes nothing, when a checkpoint the manifest names was
never committed (the JAX manager writes its manifest while an asynchronous
save is still in flight), when the flags build a tree whose leaves or shapes
differ from a checkpoint's, or when PORT_SAVE_DIR holds anything.  The
output is written into a fresh temporary directory beside PORT_SAVE_DIR and
renamed into place at the end.

It imports ``jax``, ``orbax`` and both packages, so it runs on a machine
that has JAX (the CPU is enough); the port never imports it.
"""

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import jax
import numpy as np
import orbax.checkpoint as ocp
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from ifseg_torch.checkpoint.convert import optimizer_state_from_jax, state_dict_from_jax  # noqa: E402
from ifseg_torch.checkpoint.manager import CheckpointManager as PortManager  # noqa: E402
from ifseg_torch.config import from_flags as port_flags  # noqa: E402
from ifseg_tpu.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from ifseg_tpu.config import from_flags as jax_flags  # noqa: E402


class RefusedError(ValueError):
    """The save directory cannot be converted as asked; nothing was written."""


def manifest_names(manifest: Dict[str, Any]) -> List[str]:
    """Every checkpoint the manifest names, each once, in its order."""
    names = [e["name"] for e in manifest.get("epochs", []) + manifest.get("intervals", [])]
    names += [manifest[k] for k in ("best", "last") if manifest.get(k)]
    return list(dict.fromkeys(names))


def abstract_params(cfg):
    """The shapes of the JAX model's parameters for ``cfg`` (its init traced,
    no weights made)."""
    from ifseg_tpu.models.segofa import SegOFAVariables
    from ifseg_tpu.parallel.mesh import MeshConfig, build_mesh
    from ifseg_tpu.parallel.plan import plan_from_config

    mesh = build_mesh(MeshConfig(data_parallel=1), jax.devices("cpu")[:1])
    plan = plan_from_config(cfg.distributed, mesh)
    return jax.eval_shape(lambda key: SegOFAVariables.init(cfg.model, key, plan=plan)[1],
                          jax.random.PRNGKey(cfg.optimization.seed))


def abstract_train_state(cfg):
    """The JAX ``TrainState`` that ``Trainer.init_state`` builds from ``cfg``,
    as shapes on the first CPU device (no weights are made)."""
    from ifseg_tpu.train import optim as optim_lib
    from ifseg_tpu.train.ema import ema_init
    from ifseg_tpu.train.trainer import TrainState

    params = abstract_params(cfg)
    tx, _, _ = optim_lib.build_optimizer(params, cfg.model, cfg.optimization, 1)
    ema = (jax.eval_shape(lambda p: ema_init(p, cfg.common.ema_fp32), params)
           if cfg.common.ema_decay > 0 else None)
    state = TrainState(step=jax.ShapeDtypeStruct((), np.int32), params=params,
                       opt_state=jax.eval_shape(tx.init, params), ema_params=ema)
    one = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=one), state)


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def leaf_shapes(state) -> Dict[str, tuple]:
    """``state.<path>`` -> shape of every array leaf, named as orbax names them."""
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    return {".".join(["state"] + [_key(k) for k in path]): tuple(leaf.shape)
            for path, leaf in flat}


def saved_shapes(path: str) -> Dict[str, tuple]:
    """The same for the arrays a checkpoint directory holds."""
    tree = ocp.StandardCheckpointer().metadata(path).item_metadata.tree
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype"))[0]
    return {".".join(_key(k) for k in p): tuple(leaf.shape) for p, leaf in flat
            if leaf is not None}


def check_tree(name: str, want: Dict[str, tuple], got: Dict[str, tuple]) -> None:
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or shapes:
        raise RefusedError(
            f"{name}: the flags build a tree that does not match the checkpoint "
            f"(leaves the flags make but the checkpoint lacks: {missing[:4]}; leaves only the "
            f"checkpoint has: {extra[:4]}; other shapes: "
            f"{[(k, want[k], got[k]) for k in shapes[:4]]}): pass the flags the JAX run used")


def port_optimizer(cfg):
    """The port's optimizer for ``cfg`` over a model of its shapes on the
    CPU, as ``Trainer.init_state`` builds it (its state starts at the
    optimizer's initial values; no weights are made)."""
    from ifseg_torch.models.segofa import SegOFA
    from ifseg_torch.parallel.mesh import ProcessMesh
    from ifseg_torch.parallel.plan import model_axis_size, plan_from_config
    from ifseg_torch.train import optim as optim_lib

    mesh = ProcessMesh((1, 1, model_axis_size(cfg.distributed)), 0, torch.device("cpu"),
                       join=False)
    model = SegOFA(cfg.model, plan_from_config(cfg.distributed, mesh))
    optimizer, _, _ = optim_lib.build_optimizer(model, cfg.model, cfg.optimization, 1)
    return optimizer, [n for n, _ in model.named_parameters()]


def convert(jax_dir: str, port_dir: str, flags: List[str]) -> Dict[str, Any]:
    """Convert every checkpoint of ``jax_dir`` into ``port_dir`` (see the
    module docstring); returns ``{"converted": [names], "last", "best"}``.
    Raises ``RefusedError`` before writing anything when it cannot."""
    jcfg, tcfg = jax_flags(list(flags)), port_flags(list(flags))
    manifest_path = os.path.join(jax_dir, "manifest.json")
    if not os.path.exists(manifest_path):
        raise RefusedError(f"{jax_dir}: no manifest.json, not a save directory of the JAX CLI")
    with open(manifest_path) as fp:
        manifest = json.load(fp)
    names = manifest_names(manifest)
    if not names:
        raise RefusedError(f"{jax_dir}: the manifest names no checkpoint")
    for name in names:
        path = os.path.join(jax_dir, name)
        if not os.path.isdir(path) or not ocp.utils.is_checkpoint_finalized(path):
            raise RefusedError(f"{path}: named by the manifest but never committed (an "
                               "asynchronous save that did not finish)")
    if os.path.exists(port_dir) and os.listdir(port_dir):
        raise RefusedError(f"{port_dir} is not empty")

    abstract = abstract_train_state(jcfg)
    want = leaf_shapes(abstract)
    for name in names:
        check_tree(name, want, saved_shapes(os.path.join(jax_dir, name)))

    optimizer, param_names = port_optimizer(tcfg)
    target_path = os.path.abspath(port_dir).rstrip("/")
    os.makedirs(os.path.dirname(target_path), exist_ok=True)
    staging = tempfile.mkdtemp(prefix=os.path.basename(target_path) + ".partial-",
                               dir=os.path.dirname(target_path))
    umask = os.umask(0)
    os.umask(umask)
    os.chmod(staging, 0o777 & ~umask)  # mkdtemp's 0700 is not the user's choice
    source = JaxManager(jcfg.checkpoint, save_dir=jax_dir)
    target = PortManager(tcfg.checkpoint, save_dir=staging)
    try:
        for name in names:
            state = jax.device_get(source.load(name, abstract))
            step = int(np.asarray(state.step))
            ema = None
            if state.ema_params is not None:
                shadow = state_dict_from_jax(state.ema_params)
                ema = {n: shadow[n] for n in param_names}
            target.write(name, {
                "model": state_dict_from_jax(state.params),
                "ema": ema,
                "optimizer": optimizer_state_from_jax(state.opt_state, state.params, optimizer),
                "step": step,
            })
            extra = os.path.join(jax_dir, name + ".extra.json")
            if os.path.exists(extra):
                shutil.copyfile(extra, os.path.join(staging, name + ".extra.json"))
        target.adopt_manifest(manifest)
        if os.path.exists(port_dir):
            os.rmdir(port_dir)
        os.replace(staging, port_dir)
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return {"converted": names, "last": manifest.get("last"), "best": manifest.get("best")}


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0].startswith("--") or argv[1].startswith("--"):
        sys.exit(__doc__)
    jax.config.update("jax_platforms", "cpu")
    try:
        out = convert(argv[0], argv[1], argv[2:])
    except RefusedError as e:
        sys.exit(f"orbax_to_torch: refused: {e}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
