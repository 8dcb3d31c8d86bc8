"""Carry weights into the port.

The port's parameter names are the reference torch names
(``encoder.layers.{i}.self_attn.q_proj.weight``,
``encoder.embed_images.layer3.{i}.conv2.weight``,
``encoder.token_rel_pos_table_list.{i}.weight``,
``decoder.seg_embed_tokens.weight``, ...), so a reference-layout state dict
loads with ``model.load_state_dict(sd, strict=True)``.

``state_dict_from_jax`` maps the JAX package's parameter tree into that
layout (the inverse of that package's torch -> flax converter):
  Linear   kernel (in, out)          -> weight (out, in)
  Conv     kernel (kh, kw, in, out)  -> weight (out, in, kh, kw)
  Embed    embedding                 -> weight
  LayerNorm scale/bias               -> weight/bias
  stacked (layers, ...) rel tables   -> per-layer ``*_rel_pos_table_list.{i}``
  prompt_encoder/{embedding,trans_0,trans_2}
                                     -> ``<side>_prompt_encoder.{embedding,trans.0,trans.2}``
  layers_{i}/adapter/{down,up}_proj  -> ``layers.{i}.adapter.{down,up}_proj``

``adam_state_from_jax`` carries the Adam moments of a JAX optimizer state
over in the same layout, so both trainers can start from the same moments.

``load_torch_checkpoint`` reads a fairseq ``.pt`` file, and ``load_model``
loads one, or a checkpoint directory of ``checkpoint/manager.py``, into a
fresh ``SegOFA`` (the counterpart of the JAX package's
``cli/infer.py:load_params``): ``convert_torch_state_dict``
applies the vocab surgery of a pretrained ``ofa_base.pt`` (``_vocab_surgery``)
and keeps the fresh initialisation wherever the file has no tensor or one of
another shape, as the JAX package's ``_reconcile`` does (the seg-specific
tensors, absent from ``ofa_base.pt``).  ``fabricate_ofa_base_checkpoint``
writes a file of ``ofa_base.pt``'s shapes with random weights.
``prune_layers`` keeps some layers of a deeper checkpoint (LayerDrop
pruning, ``--encoder/decoder-layers-to-keep``), before ``load_model``
reconciles it with the model.
"""

import logging
import os
import re
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model state of a fairseq ``.pt`` checkpoint (the ``model`` entry
    of its envelope, or the file itself when it is a bare state dict), as
    fp32 CPU tensors."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state.get("model", state)
    return {k: v.float() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params tree (nested dicts of numpy arrays) -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}
    emb = np.asarray(params["embed_tokens"]["embedding"])
    sd["encoder.embed_tokens.weight"] = emb
    sd["decoder.embed_tokens.weight"] = emb

    def put_linear(tname, node):
        sd[f"{tname}.weight"] = np.asarray(node["kernel"]).T
        if "bias" in node:
            sd[f"{tname}.bias"] = np.asarray(node["bias"])

    def put_ln(tname, node):
        sd[f"{tname}.weight"] = np.asarray(node["scale"])
        sd[f"{tname}.bias"] = np.asarray(node["bias"])

    def put_embed(tname, node):
        sd[f"{tname}.weight"] = np.asarray(node["embedding"])

    def put_conv(tname, node):
        sd[f"{tname}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)

    def put_bn(tname, node):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{tname}.{leaf}"] = np.asarray(node[leaf])

    for side in ("encoder", "decoder"):
        p = params[side]
        for name in ("pos_ln", "image_pos_ln", "seg_pos_ln", "layernorm_embedding",
                     "patch_layernorm_embedding", "layer_norm"):
            if name in p:
                put_ln(f"{side}.{name}", p[name])
        for name in ("pos_q_linear", "pos_k_linear", "self_pos_q_linear",
                     "self_pos_k_linear", "cross_pos_q_linear", "cross_pos_k_linear",
                     "image_proj"):
            if name in p:
                put_linear(f"{side}.{name}", p[name])
        for name in ("embed_positions", "embed_image_positions", "embed_seg_positions",
                     "type_embedding"):
            if name in p:
                put_embed(f"{side}.{name}", p[name])
        for ours in ("token_rel_pos_table", "image_rel_pos_table", "seg_rel_pos_table"):
            if ours in p:
                table = np.asarray(p[ours])
                for i in range(table.shape[0]):
                    sd[f"{side}.{ours}_list.{i}.weight"] = table[i]
        for name in ("seg_embed_tokens", "seg_projection"):
            if name in p:
                sd[f"{side}.{name}.weight"] = np.asarray(p[name])
        if "prompt_encoder" in p:
            pe = p["prompt_encoder"]
            put_embed(f"{side}.{side}_prompt_encoder.embedding", pe["embedding"])
            for ours, theirs in (("trans_0", "trans.0"), ("trans_2", "trans.2")):
                if ours in pe:
                    put_linear(f"{side}.{side}_prompt_encoder.{theirs}", pe[ours])

        num_layers = sum(1 for k in p if k.startswith("layers_"))
        for i in range(num_layers):
            lp = p[f"layers_{i}"]
            base = f"{side}.layers.{i}"
            for attn in ("self_attn", "encoder_attn"):
                if attn not in lp:
                    continue
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    put_linear(f"{base}.{attn}.{proj}", lp[attn][proj])
                if "c_attn" in lp[attn]:
                    sd[f"{base}.{attn}.c_attn"] = np.asarray(lp[attn]["c_attn"])
            for ln_name in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                            "final_layer_norm", "attn_ln", "self_attn_ln", "cross_attn_ln"):
                if ln_name in lp:
                    put_ln(f"{base}.{ln_name}", lp[ln_name])
            put_linear(f"{base}.fc1", lp["ffn"]["fc1"])
            put_linear(f"{base}.fc2", lp["ffn"]["fc2"])
            if "ffn_layernorm" in lp["ffn"]:
                put_ln(f"{base}.ffn_layernorm", lp["ffn"]["ffn_layernorm"])
            if "w_resid" in lp:
                sd[f"{base}.w_resid"] = np.asarray(lp["w_resid"])
            if "adapter" in lp:
                for proj in ("down_proj", "up_proj"):
                    put_linear(f"{base}.adapter.{proj}", lp["adapter"][proj])

    stem = params["encoder"]["embed_images"]
    put_conv("encoder.embed_images.conv1", stem["conv1"])
    put_bn("encoder.embed_images.bn1", stem["bn1"])
    for key, node in stem.items():
        if not key.startswith("layer"):
            continue
        stage, idx = key[len("layer")], key.split("_")[1]
        base = f"encoder.embed_images.layer{stage}.{idx}"
        for sub in ("conv1", "conv2", "conv3"):
            put_conv(f"{base}.{sub}", node[sub])
        for sub in ("bn1", "bn2", "bn3"):
            put_bn(f"{base}.{sub}", node[sub])
        if "downsample_conv" in node:
            put_conv(f"{base}.downsample.0", node["downsample_conv"])
            put_bn(f"{base}.downsample.1", node["downsample_bn"])

    # the JAX model never creates the decoder's image position table (no path
    # of that package reads it); the reference decoder holds one, so the
    # port does too, and it is filled with zeros here
    if "decoder.embed_image_positions.weight" not in sd:
        rows = sd["encoder.embed_image_positions.weight"].shape[0]
        dim = sd["decoder.layer_norm.weight"].shape[0]
        sd["decoder.embed_image_positions.weight"] = np.zeros((rows, dim), np.float32)

    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _find_adam_state(node):
    """The first node of an optimizer-state tree that has count, mu and nu."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    children = node.values() if isinstance(node, dict) else (
        node if isinstance(node, (tuple, list)) else ())
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def _fill_masked(tree, params):
    """``tree`` with the shape of ``params``; leaves that are not arrays (the
    placeholders of frozen parameters) become zeros."""
    if isinstance(params, dict):
        return {k: _fill_masked(tree[k], v) for k, v in params.items()}
    return np.asarray(tree) if hasattr(tree, "shape") else np.zeros_like(np.asarray(params))


def adam_state_from_jax(opt_state: Any, params: Dict[str, Any]) -> Dict[str, Any]:
    """The Adam state inside a JAX optimizer state (any nesting of tuples and
    dicts around a node with ``count``, ``mu`` and ``nu``) -> ``{"count": int,
    "mu": state dict, "nu": state dict}`` under the port's parameter names,
    for ``FairseqAdam.load_state``.  ``params`` is the JAX parameter tree; it
    gives the moments of frozen parameters, which JAX does not keep, their
    shape (zeros)."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    return {
        "count": int(np.asarray(adam.count)),
        "mu": state_dict_from_jax(_fill_masked(adam.mu, params)),
        "nu": state_dict_from_jax(_fill_masked(adam.nu, params)),
    }


# ------------------------------------------------- a pretrained .pt file

_EMBED_KEYS = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight")


def _vocab_surgery(sd: Dict[str, torch.Tensor], target_vocab: int):
    """segofa.py:247-290: bring the token embedding to ``target_vocab`` rows.
    One row too many (a trailing <mask>) is cut; rows that are missing (the
    IFSeg case: one, for the extra seg/unknown symbol) are appended as
    N(0, d^-0.5) draws of ``np.random.default_rng(0)``, the numbers the JAX
    package appends."""
    key = "encoder.embed_tokens.weight"
    if key not in sd:
        return sd
    loaded, d = sd[key].shape
    if loaded == target_vocab + 1:
        for k in (*_EMBED_KEYS, "encoder.output_projection.weight",
                  "decoder.output_projection.weight"):
            if k in sd:
                sd[k] = sd[k][:-1]
    elif loaded < target_vocab:
        n_add = target_vocab - loaded
        new_rows = torch.from_numpy(np.random.default_rng(0).normal(
            0.0, d ** -0.5, size=(n_add, d)).astype(np.float32)).to(sd[key].dtype)
        logger.info("vocab surgery: appending %d embedding rows", n_add)
        for k in _EMBED_KEYS:
            if k in sd:
                sd[k] = torch.cat([sd[k], new_rows], dim=0)
    return sd


# the tensors of the option paths (encoder_module.py:989-1027,
# unify_transformer_layer.py:49-94) under the reference names
_TUNED_KEY = re.compile(r"^(encoder\.encoder|decoder\.decoder)_prompt_encoder\.|"
                        r"^(encoder|decoder)\.layers\.\d+\.adapter\.")


def convert_torch_state_dict(sd: Dict[str, torch.Tensor], target_vocab: int,
                             reference_sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict (reference names) made loadable into the
    model whose fresh ``state_dict()`` is ``reference_sd``: the vocab
    surgery, the encoder's token embedding for the shared one, a tensor of
    the file where its shape matches and the fresh one where the file has
    none or another shape (encoder_module.py:966-985).  The result loads
    with ``load_state_dict(strict=True)``; keys the model has no place for
    are logged, except a prompt encoder's or an adapter's
    (``<side>_prompt_encoder.*``, ``layers.N.adapter.*``, the names of the
    JAX package's converter), which raise: a checkpoint tuned with those
    options loaded into a model without them would answer without the
    tuning."""
    sd = _vocab_surgery(dict(sd), target_vocab)
    if "encoder.embed_tokens.weight" in sd:  # tied: the encoder's copy wins
        sd["decoder.embed_tokens.weight"] = sd["encoder.embed_tokens.weight"]
    out = {}
    for k, ref in reference_sd.items():
        loaded = sd.get(k)
        if loaded is None:
            logger.info("missing from checkpoint, keeping fresh init: %s", k)
            out[k] = ref
        elif tuple(loaded.shape) != tuple(ref.shape):
            logger.warning("shape mismatch %s: ckpt %s vs model %s, keeping fresh init",
                           k, tuple(loaded.shape), tuple(ref.shape))
            out[k] = ref
        else:
            out[k] = loaded.to(ref.dtype)
    unused = sorted(k for k in sd if k not in reference_sd)
    tuned = [k for k in unused if _TUNED_KEY.match(k)]
    if tuned:
        raise ValueError(
            f"the checkpoint holds {len(tuned)} prompt-encoder or adapter tensor(s) the model "
            f"config has no place for ({', '.join(tuned[:4])}{' ...' if len(tuned) > 4 else ''}): "
            "pass --encoder-prompt / --decoder-prompt / --adapter (with their lengths and "
            "widths) as the checkpoint was trained")
    if unused:
        logger.warning("checkpoint conversion skipped %d tensor(s) with no place in the "
                       "model: %s%s", len(unused), ", ".join(unused[:8]),
                       " ..." if len(unused) > 8 else "")
    return out


def prune_layers(sd: Dict[str, torch.Tensor], encoder_layers_to_keep: Optional[str] = None,
                 decoder_layers_to_keep: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """LayerDrop pruning (ref utils/checkpoint_utils.py:692-784) of a state
    dict of the reference names: on each side given, keep the listed layer
    indices ("0,2,4") of the checkpoint, renumbered as the JAX package's
    ``prune_layers`` renumbers them (the sorted list's first position of the
    index), and the per-layer relative tables as its stacked tables are
    indexed by that list; everything else passes.  An index past the
    checkpoint's layers raises."""
    out = dict(sd)
    for side, keep in (("encoder", encoder_layers_to_keep), ("decoder", decoder_layers_to_keep)):
        if not keep:
            continue
        keep_idx = sorted(int(x) for x in keep.split(","))
        layer = re.compile(rf"^{side}\.layers\.(\d+)\.(.*)$")
        table = re.compile(rf"^{side}\.(\w+_rel_pos_table_list)\.(\d+)\.(.*)$")
        n_layers = len({m.group(1) for k in sd for m in [layer.match(k)] if m})
        bad = [i for i in keep_idx if not 0 <= i < n_layers]
        if bad:
            raise ValueError(f"layers-to-keep indices {bad} out of range for a "
                             f"{n_layers}-layer checkpoint")
        tables = {}
        for k in list(out):
            m = layer.match(k)
            if m:
                del out[k]
                if int(m.group(1)) in keep_idx:
                    out[f"{side}.layers.{keep_idx.index(int(m.group(1)))}.{m.group(2)}"] = sd[k]
                continue
            m = table.match(k)
            if m:
                del out[k]
                tables.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = sd[k]
        for (name, leaf), by_layer in tables.items():
            if len(by_layer) != n_layers:
                raise ValueError(f"{side}.{name} has {len(by_layer)} tables for {n_layers} layers")
            for j, i in enumerate(keep_idx):
                out[f"{side}.{name}.{j}.{leaf}"] = by_layer[i]
    return out


def load_model(path: str, model_cfg, ema: bool = False, encoder_layers_to_keep: str = "",
               decoder_layers_to_keep: str = ""):
    """A ``SegOFA(model_cfg)`` with the weights of ``path``, on the CPU: a
    fairseq ``.pt`` file (its envelope or a bare state dict; a port state
    dict saved with ``torch.save`` is one), loaded into a fresh model from
    ``torch.Generator`` seed 0 with ``convert_torch_state_dict``; or a
    checkpoint directory of ``checkpoint/manager.py`` (``checkpoint_best``
    and ``checkpoint_last`` are links to one), whose ``model.pt`` loads
    strictly, its parameters replaced by ``ema.pt``'s when ``ema`` is set
    and the checkpoint has an EMA copy.  The layers-to-keep lists prune the
    checkpoint first (``prune_layers``), so a shallower ``model_cfg`` takes
    the kept layers.  The counterpart of the JAX package's
    ``cli/infer.py:load_params``, which reads orbax directories instead."""
    from ifseg_torch.models.segofa import SegOFA

    prune = lambda sd: prune_layers(sd, encoder_layers_to_keep, decoder_layers_to_keep)
    model = SegOFA(model_cfg).init(torch.Generator().manual_seed(0))
    if os.path.isdir(path):
        model.load_state_dict(prune(
            torch.load(os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)),
            strict=True)
        ema_path = os.path.join(path, "ema.pt")
        if ema and os.path.exists(ema_path):
            shadow = prune(torch.load(ema_path, map_location="cpu", weights_only=True))
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(shadow[name])
        return model
    if not str(path).endswith(".pt"):
        raise ValueError(f"{path}: neither a .pt file nor a checkpoint directory")
    # pruned before the reconcile, so the kept layers land on a shallower
    # model rather than being back-filled with fresh values
    sd = prune(load_torch_checkpoint(path))
    model.load_state_dict(
        convert_torch_state_dict(sd, model_cfg.vocab_size, model.state_dict()), strict=True)
    return model


# the tensors a pretrained ofa_base.pt does not have (IFSeg adds them)
_SEG_ONLY_KEYS = (
    "seg_embed_tokens", "seg_projection", "embed_seg_positions",
    "seg_pos_ln", "seg_rel_pos_table_list",
)


def fabricate_ofa_base_checkpoint(path: str, model_cfg, seed: int = 0,
                                  device: Optional[Union[str, torch.device]] = None) -> str:
    """Write a fairseq-envelope ``.pt`` with the SHAPES of a pretrained
    ``ofa_base.pt`` relative to ``model_cfg``: the port's fresh init from
    ``seed``, the token embedding one row short of the target vocab (the row
    the surgery appends) and no seg-specific tensors, so ``load_model`` runs
    its whole path, surgery and backfill included, without real weights.
    The model is built on ``device`` (``"cuda"`` unless ``"cpu"`` is asked
    for; a CUDA generator builds a large model in a fraction of the CPU's
    time) and saved from the CPU."""
    from ifseg_torch.models.segofa import SegOFA

    device = torch.device("cuda" if device is None else device)
    with torch.device(device):
        model = SegOFA(model_cfg)
    model.init(torch.Generator(device=device).manual_seed(seed))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if not any(seg in k for seg in _SEG_ONLY_KEYS)}
    emb = sd[_EMBED_KEYS[0]][:-1].clone()  # one storage for the tied pair
    for k in _EMBED_KEYS:
        sd[k] = emb
    torch.save({"args": None, "cfg": {}, "model": sd, "extra_state": {},
                "optimizer_history": []}, path)
    logger.warning("fabricated an ofa_base-shaped checkpoint at %s (%d tensors): random "
                   "weights, for loader runs only", path, len(sd))
    return path
