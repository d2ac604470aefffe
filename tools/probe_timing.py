"""Timing from torch.profiler for the probes in this directory."""

import torch


def profiled_ms(fn, calls=10):
  """{kernel name: device ms a call} over `calls` calls, from
  torch.profiler's CUDA activity."""
  fn()
  torch.cuda.synchronize()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  out = {}
  for event in prof.key_averages():
    device_us = getattr(event, 'device_time_total', 0.0)
    if device_us > 0:
      out[event.key] = device_us / calls / 1e3
  return out
