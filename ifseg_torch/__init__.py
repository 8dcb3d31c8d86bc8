"""IFSeg in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The package stands beside the JAX package ``ifseg_tpu`` and imports none of
it.  Its entry points: the fixed-shape serving forward
(``ifseg_torch.eval.serving.SegServer``), the image-free training step
(``ifseg_torch.train.trainer.Trainer``), native-resolution evaluation
(``ifseg_torch.eval.evaluator.Evaluator``) and validation from TSV rows to
mIoU (``python -m ifseg_torch.cli.validate``).
"""
