"""Where the time goes in the PyTorch port's main path, on one CUDA card.

    python3 tools/profile_torch_pd1.py [--steps 40] [--bo-iters 20]

Builds the PD1-shape configuration of chip_smoke.py (23 tasks x 2048
points x 4-d, batch 100, linear_mlp mean, squared_exponential_mlp kernel)
and measures, in one process on one card:

  * ms/step of GP training, with kernel K1 and with K1 swapped for its
    plain PyTorch version, in turns (plain, kernel, kernel, plain), so
    that the kernel's end-to-end effect is read on one card;
  * ms/iter of EI BO over 10,000 candidates;
  * a torch.profiler window over training steps and one over BO
    iterations: the device's busy and idle share of the window's wall
    time, and the kernels taking the most device time;
  * the compile-once paths of chip_smoke.py's phases 13-15, each timed and
    then profiled the same way, with the device activities (kernels,
    copies, fills) a step or an iteration: the packed runner
    (make_fit_adam_packed with fast_subsample), the plain on-device BO at
    bench.py's configuration (EI, 10,000 candidates, 100 iterations), its
    q-batch runner (q = 4) and its retrain runner (every 5 iterations, 10
    steps, 8 tasks x 100 points); and chip_smoke.py's phases 17-18, the
    HGP runners: fixed samples (S = 8) and re-sampling (8 chains, a sweep
    every 5 iterations on the 8-task corpus).

The swap to the plain version exists only in this measurement script; the
library itself never routes a CUDA tensor around the kernel.
"""

import argparse
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from hyperbo_tpu_torch.bo import acfun, bayesopt  # noqa: E402
from hyperbo_tpu_torch.core import defs  # noqa: E402
from hyperbo_tpu_torch.core.warp import DEFAULT_WARP_FUNC  # noqa: E402
from hyperbo_tpu_torch.models import gp, kernel, mean  # noqa: E402
from hyperbo_tpu_torch.ops import batch_chol  # noqa: E402


def _model(dataset, steps, dev):
  model = gp.GP(dataset, mean.linear_mlp, kernel.squared_exponential_mlp,
                chip_smoke.init_params(steps), DEFAULT_WARP_FUNC,
                device=dev)
  model.initialize_params(torch.Generator(device=dev).manual_seed(0))
  return model


def _train_ms(model, steps):
  params0 = {k: v for k, v in model.params.model.items()}
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  model.train(torch.Generator(device=model.device).manual_seed(1))
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3 / steps
  model.update_model_params(params0)
  return ms


def _busy_share(prof, wall_us):
  """Union of the device-side event intervals over the window's wall."""
  spans = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
  busy, end = 0, None
  for s, e in spans:
    if end is None or s > end:
      busy += e - s
      end = e
    elif e > end:
      busy += e - end
      end = e
  return busy / wall_us if wall_us else float('nan')


def _profile(fn, title, count=None):
  """Profile one call of fn; with `count` (steps or iterations in the
  call), also the device activities per step or iteration."""
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
  share = _busy_share(prof, wall_us)
  per = ''
  if count:
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    per = f', {n / count:.1f} device activities per step or iteration'
  print(f'--- {title}: window {wall_us / 1e3:.3f} ms, device busy '
        f'{100 * share:.1f}%, idle {100 * (1 - share):.1f}%{per}')
  print(prof.key_averages().table(sort_by='self_cuda_time_total',
                                  row_limit=12, max_name_column_width=60))


def _timed_ms(fn, count):
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) * 1e3 / count


def _compile_once_paths(model, candidates, dev):
  """Time, then profile, the packed runner and the five on-device BO
  runners at chip_smoke.py's shapes and depths."""
  from hyperbo_tpu_torch.bo import ondevice
  from hyperbo_tpu_torch.models import packed as packed_lib
  from hyperbo_tpu_torch.train import adam

  steps, iters = chip_smoke.STEPS, chip_smoke.BO_LOOP_ITERS
  config = dict(model.params.config, fast_subsample=True,
                max_training_step=steps)
  packed, _ = packed_lib.pack_dataset(model.dataset, pad_to_multiple=128,
                                      device=dev)
  run = adam.make_fit_adam_packed(mean.linear_mlp,
                                  kernel.squared_exponential_mlp, config,
                                  warp_func=DEFAULT_WARP_FUNC)
  gen = torch.Generator(device=dev).manual_seed(0)
  train = lambda: run(model.params.model, packed, gen)
  train()
  print(f'packed runner (fast_subsample): {_timed_ms(train, steps):.3f} '
        'ms/step')
  _profile(train, f'packed runner, {steps} steps', steps)

  bo_model = chip_smoke.bo_model(dev)
  queried = defs.SubDataset(torch.from_numpy(candidates[0]).to(dev),
                            torch.from_numpy(candidates[1]).to(dev))
  common = (mean.constant, kernel.squared_exponential, bo_model,
            {'learning_rate': 1e-2}, DEFAULT_WARP_FUNC, queried)
  pp = chip_smoke.retrain_corpus(dev)
  q = chip_smoke.QBATCH
  runs = {
      'plain': (lambda: ondevice.simulated_bayesopt_ondevice(
          *common, iters, num_train_tasks=chip_smoke.TASKS, generator=gen,
          device=dev), iters),
      'q-batch': (lambda: ondevice.simulated_bayesopt_ondevice_qbatch(
          *common, iters // q, q=q,
          num_train_tasks=chip_smoke.RETRAIN_TASKS, generator=gen,
          device=dev), iters // q),
      'retrain': (lambda: ondevice.simulated_bayesopt_ondevice_retrain(
          *common, iters, num_train_tasks=chip_smoke.RETRAIN_TASKS,
          pretrain_packed=pp, retrain_every=chip_smoke.RETRAIN_EVERY,
          retrain_steps=chip_smoke.RETRAIN_STEPS, generator=gen,
          device=dev), iters),
      'HGP fixed samples': (lambda: ondevice.simulated_bayesopt_ondevice_hgp(
          mean.constant, kernel.squared_exponential,
          chip_smoke.hgp_samples(dev), {'learning_rate': 1e-2},
          DEFAULT_WARP_FUNC, queried, iters,
          num_train_tasks=chip_smoke.TASKS, generator=gen, device=dev),
                            iters),
      'HGP re-sampling': (
          lambda: ondevice.simulated_bayesopt_ondevice_hgp_resample(
              *common, iters, num_samples=chip_smoke.HGP_SAMPLES,
              num_train_tasks=chip_smoke.RETRAIN_TASKS, pretrain_packed=pp,
              resample_every=chip_smoke.RESAMPLE_EVERY,
              sweeps=chip_smoke.RESAMPLE_SWEEPS, generator=gen, device=dev),
          iters),
  }
  for name, (fn, count) in runs.items():
    fn()
    print(f'on-device BO, {name}: {_timed_ms(fn, count):.3f} ms/iter')
    _profile(fn, f'on-device BO, {name}, {count} iterations', count)


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--steps', type=int, default=40)
  parser.add_argument('--bo-iters', type=int, default=20)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit('profile_torch_pd1: CUDA is not available')
  dev = torch.device('cuda', 0)
  chip_smoke.phase_device()
  dataset, candidates, _ = chip_smoke.make_data()
  model = _model(dataset, args.steps, dev)

  kernel_route = batch_chol.batched_linv_t

  def plain_route(kb):
    return batch_chol.linv_t_plain(0.5 * (kb + kb.transpose(-1, -2)))

  routes = {'plain': plain_route, 'kernel': kernel_route}
  for route in routes.values():  # warm-up: K1 build, cuSOLVER, allocator
    batch_chol.batched_linv_t = route
    _train_ms(model, args.steps)
  times = {'plain': [], 'kernel': []}
  for name in ('plain', 'kernel', 'kernel', 'plain') * 2:
    batch_chol.batched_linv_t = routes[name]
    times[name].append(_train_ms(model, args.steps))
  batch_chol.batched_linv_t = kernel_route
  for name, ts in times.items():
    print(f'training, K1 {name}: {statistics.median(ts):.3f} ms/step '
          f'(runs {", ".join(f"{t:.3f}" for t in ts)})')

  model.params.config['max_training_step'] = 5
  _profile(lambda: model.train(
      torch.Generator(device=dev).manual_seed(2)), 'training, 5 steps', 5)

  cand = defs.SubDataset(*candidates)
  bayesopt.simulated_bayesopt(model, 'warm', cand, acfun.ei, 3)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  bayesopt.simulated_bayesopt(model, 'test', cand, acfun.ei, args.bo_iters)
  torch.cuda.synchronize()
  print(f'BO: {(time.perf_counter() - t0) * 1e3 / args.bo_iters:.3f} '
        f'ms/iter over {len(candidates[0])} candidates')
  _profile(lambda: bayesopt.simulated_bayesopt(model, 'test', cand,
                                               acfun.ei, 5),
           'BO, 5 iterations', 5)
  _compile_once_paths(model, candidates, dev)


if __name__ == '__main__':
  main()
