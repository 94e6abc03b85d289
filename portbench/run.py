"""Run one benchmark cell once: see harness.py.

    python3 portbench/run.py --workload sno_like-muon16m.steps \
        --seed 12345 --seconds 30 --trace 0

Every cache the program and its libraries keep lies at a fixed path
under ``portbench/.cache`` inside the checkout: the packed tables and
the SNO-like GDML (CHROMA_TPU_CACHE), Triton's and PyTorch's extension
caches.  The CUDA kernels build into ``chroma_tpu_torch/_build``.
"""
import os
import sys
import time

T_PROCESS = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, 'portbench', '.cache')
os.environ['CHROMA_TPU_CACHE'] = os.path.join(CACHE, 'chroma_tpu')
os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
os.environ['CUDA_CACHE_PATH'] = os.path.join(CACHE, 'nv')
os.environ['USE_FLAX'] = '0'
# the checkout's root, not this folder, is where imports start
sys.path[0] = ROOT

from portbench import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(t_process=T_PROCESS))
