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

``load_torch_checkpoint`` reads a fairseq ``.pt`` file.  A pretrained
``ofa_base.pt`` still needs the vocab surgery and the backfill of the
seg-specific tensors before it loads strictly; those come with the
checkpoint-loading work.
"""

from typing import Any, Dict

import numpy as np
import torch


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
