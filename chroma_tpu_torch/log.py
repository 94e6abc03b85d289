"""The port's logger (counterpart of chroma_tpu/log.py)."""
import logging

logger = logging.getLogger('chroma_tpu_torch')
logger.addHandler(logging.NullHandler())
