"""Fixed-shape serving: precompute every batch-independent tensor once.

All of SegOFA's attention biases and position embeddings depend only on the
parameters and the (static) input shape.  A server therefore computes them
once per checkpoint (``precompute``) and runs a lean per-request forward
(``forward_served``) that skips the gathers, bias interpolations and q·k
position products.

    server = SegServer(model, src_len=32)            # on "cuda"
    logits = server(src_tokens, images, bos)         # (B, 1+hw, C) fp32

``quantize="int8"`` serves weight-only int8, as the JAX package's
``SegServer`` does (ops/quantization.py; the reference's
quantize_model_scalar, quantization_utils.py:15).
"""

from typing import Dict, Optional, Union

import torch

from ifseg_torch.models.encoder import compute_dtype
from ifseg_torch.models.segofa import SegOFA
from ifseg_torch.ops.quantization import Int8Linear, quantize_state_scalar, scalar_dequantize


def precompute(model: SegOFA, src_len: int) -> Dict[str, Dict[str, torch.Tensor]]:
    s = model.cfg.patch_image_size // 16
    enc = model.encoder.precompute_biases(src_len, (s, s))
    dec = model.decoder.precompute_biases(enc["pos_all"], (s, s))
    return {"enc": enc, "dec": dec}


def forward_served(model: SegOFA, pre, src_tokens, patch_images, bos_tokens):
    enc_out = model.encoder.encode_served(src_tokens, patch_images, pre["enc"])
    return model.decoder.decode_served(bos_tokens, enc_out, pre["dec"])


class SegServer:
    """Holds the model on its device, the bias pack, and the weights cast to
    compute dtype once.

    ``device=None`` means ``"cuda"`` and raises when no card is present; the
    CPU is used only when the caller passes ``device="cpu"``.  The server owns
    its model: it is moved and cast in place (``SegOFA.cast_for_serving``),
    so a model handed to a server serves and does nothing else.  (The
    ``Evaluator`` is the other way round: it leaves its model alone and runs
    a cast copy of it.)

    ``quantize="int8"``: the bias pack is computed from the unquantized
    weights, then every large weight is quantized with a scale per channel
    (``quantize_state_scalar``; ``quant_report`` counts them as the JAX
    package does).  The ``serving_linears`` stay int8 codes and fp32 scales
    on the device and are dequantized inside each forward
    (``Int8Linear``); every other quantized tensor (the ResNet's
    convolutions, before their batch norm is folded in, the embeddings, the
    seg embedding) holds its dequantized values from the start, the values a
    dequantization at each forward gives."""

    def __init__(self, model: SegOFA, src_len: int,
                 device: Optional[Union[str, torch.device]] = None,
                 quantize: str = "none"):
        if quantize not in ("none", "", None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SegServer: no CUDA device (pass device='cpu' to run on the CPU)")
        self.model = model.to(self.device).eval()
        self.src_len = src_len
        with torch.inference_mode():
            self.pre = precompute(self.model, src_len)
        self.quant_report = None
        if quantize == "int8":
            self.quant_report = _quantize_int8(self.model)
        self.model.cast_for_serving(compute_dtype(model.cfg))

    def __call__(self, src_tokens, patch_images, bos_tokens) -> torch.Tensor:
        with torch.inference_mode():
            return forward_served(
                self.model, self.pre,
                torch.as_tensor(src_tokens, device=self.device),
                torch.as_tensor(patch_images, device=self.device),
                torch.as_tensor(bos_tokens, device=self.device),
            )


@torch.no_grad()
def _quantize_int8(model: SegOFA) -> Dict[str, int]:
    """Quantize ``model`` in place for int8 serving (see ``SegServer``)."""
    quantized, report = quantize_state_scalar(model)
    served = {id(m) for m in model.serving_linears()}
    for name, mod in list(model.named_modules()):
        if id(mod) in served and f"{name}.weight" in quantized:
            parent, _, attr = name.rpartition(".")
            q, scale = quantized.pop(f"{name}.weight")
            setattr(model.get_submodule(parent), attr, Int8Linear(q, scale, mod.bias))
    params = dict(model.named_parameters(remove_duplicate=False))
    for key, (q, scale) in quantized.items():
        params[key].copy_(scalar_dequantize(q, scale))
    return report
