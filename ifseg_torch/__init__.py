"""IFSeg in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The package stands beside the JAX package ``ifseg_tpu`` and imports none of
it.  This version holds the fixed-shape serving forward of SegOFA:
``ifseg_torch.eval.serving.SegServer``.
"""
