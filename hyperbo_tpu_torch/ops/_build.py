"""Build and load the port's hand-written CUDA kernels.

Each `.cu` file under hyperbo_tpu_torch/csrc/ exports plain C functions.
At first use it is compiled by `nvcc` for Hopper (sm_90a) into a shared
library and loaded with ctypes. The library goes to build/hyperbo_tpu_torch/
at the root of the checkout, under a name keyed by a hash of the source, the
shared headers (csrc/*.cuh) and the compiler flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. `build_all` compiles
several sources at once, one nvcc process each. Nothing here runs at import
time: the CPU-only test environment has no nvcc and imports every module.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'hyperbo_tpu_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def find_nvcc() -> str:
  """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
  candidates = []
  if os.environ.get('CUDA_HOME'):
    candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
  on_path = shutil.which('nvcc')
  if on_path:
    candidates.append(on_path)
  candidates.append('/usr/local/cuda/bin/nvcc')
  for path in candidates:
    if os.path.isfile(path) and os.access(path, os.X_OK):
      return path
  raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, PATH and '
                     '/usr/local/cuda/bin): the CUDA kernels of '
                     'hyperbo_tpu_torch cannot be built.')


class CudaKernel:
  """One C entry point of a `.cu` file, built at first use.

  `launches` counts the calls of `launch`, i.e. the kernel launches made
  through this object; callers reset it to 0 to count a window of work.
  """

  def __init__(self, source: str, symbol: str,
               argtypes: Sequence[type]):
    self.source = source
    self.symbol = symbol
    self.argtypes = list(argtypes)
    self.launches = 0
    self.build_seconds: Optional[float] = None
    self.build_log = ''
    self._fn = None

  @property
  def source_path(self) -> str:
    return os.path.join(CSRC_DIR, self.source)

  def library_path(self) -> str:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [self.source_path,
                 *sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh')))]:
      with open(path, 'rb') as f:
        digest.update(f.read())
    stem = os.path.splitext(self.source)[0]
    return os.path.join(BUILD_DIR, f'lib{stem}_{digest.hexdigest()[:16]}.so')

  def build(self):
    """Compile (unless a library of this exact source exists) and load."""
    if self._fn is not None:
      return self._fn
    lib_path = self.library_path()
    t0 = time.perf_counter()
    if not os.path.exists(lib_path):
      os.makedirs(BUILD_DIR, exist_ok=True)
      fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
      os.close(fd)
      cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, self.source_path]
      proc = subprocess.run(cmd, capture_output=True, text=True)
      self.build_log = proc.stdout + proc.stderr
      if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed for {self.source} '
                           f'(exit {proc.returncode}):\n{self.build_log}')
      os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    fn = getattr(lib, self.symbol)
    fn.argtypes = self.argtypes
    fn.restype = ctypes.c_int
    self.build_seconds = time.perf_counter() - t0
    self._fn = fn
    return fn

  def launch(self, *args):
    """Call the entry point; raise if it reports a CUDA error."""
    err = self.build()(*args)
    if err != 0:
      raise RuntimeError(f'{self.symbol} failed to launch: CUDA error '
                         f'{err}')
    self.launches += 1


def check_cuda_f32(name: str, **tensors):
  """Raise unless every tensor given (None skipped) is a contiguous float32
  CUDA tensor: what a kernel entry point takes."""
  for key, t in tensors.items():
    if t is None:
      continue
    if t.device.type != 'cuda':
      raise ValueError(f'{name} needs CUDA tensors, got {key} on {t.device}')
    if t.dtype != torch.float32:
      raise TypeError(f'{name} needs float32, got {key} of {t.dtype}')
    if not t.is_contiguous():
      raise ValueError(f'{name} needs contiguous tensors, {key} is not')


def build_all(kernels: Sequence[CudaKernel]):
  """Build the kernels concurrently (each nvcc runs in its own process)."""
  with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
    for future in [pool.submit(k.build) for k in kernels]:
      future.result()
