"""Distribution layer of the port (counterpart of huffman_tpu/parallel/):
``pipeline`` on ``torch.distributed`` process groups."""

from . import pipeline

__all__ = ["pipeline"]
