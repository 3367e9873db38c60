"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR (port of
deepspeed_tpu/runtime/lr_schedules.py: the same schedule math and JSON
param names).

A schedule wraps an optimizer-like object exposing `param_groups` (the
engine passes a single-group shim) and is stepped on the host. Each
schedule also has a step-indexed form, `device_schedule_fn(name,
params)(step)`: a function of the count of prior optimizer steps that
takes a Python int or a device tensor. The engine evaluates it on its
device step counter, so the learning rate rides a device scalar and no
step reads anything back to the host. It equals the host class's
`get_lr()[0]` at `last_batch_iteration == step` (fp32 on the device vs
float64 on the host: parity to ~1e-6 relative).

`add_tuning_arguments(parser)` adds the schedules' command-line flags
(the JAX package's namespace), `get_config_from_args(args)` turns them
into a scheduler block.
"""

import argparse
import math

import torch

from deepspeed_tpu_torch.utils.logging import logger

LR_SCHEDULE = 'lr_schedule'
LR_RANGE_TEST = 'LRRangeTest'
ONE_CYCLE = 'OneCycle'
WARMUP_LR = 'WarmupLR'
WARMUP_DECAY_LR = 'WarmupDecayLR'
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = 'lr_range_test_min_lr'
LR_RANGE_TEST_STEP_RATE = 'lr_range_test_step_rate'
LR_RANGE_TEST_STEP_SIZE = 'lr_range_test_step_size'
LR_RANGE_TEST_STAIRCASE = 'lr_range_test_staircase'

CYCLE_FIRST_STEP_SIZE = 'cycle_first_step_size'
CYCLE_FIRST_STAIR_COUNT = 'cycle_first_stair_count'
CYCLE_SECOND_STEP_SIZE = 'cycle_second_step_size'
CYCLE_SECOND_STAIR_COUNT = 'cycle_second_stair_count'
DECAY_STEP_SIZE = 'decay_step_size'

CYCLE_MIN_LR = 'cycle_min_lr'
CYCLE_MAX_LR = 'cycle_max_lr'
DECAY_LR_RATE = 'decay_lr_rate'

CYCLE_MIN_MOM = 'cycle_min_mom'
CYCLE_MAX_MOM = 'cycle_max_mom'
DECAY_MOM_RATE = 'decay_mom_rate'

WARMUP_MIN_LR = 'warmup_min_lr'
WARMUP_MAX_LR = 'warmup_max_lr'
WARMUP_NUM_STEPS = 'warmup_num_steps'
TOTAL_NUM_STEPS = 'total_num_steps'


def add_tuning_arguments(parser):
    group = parser.add_argument_group('Convergence Tuning',
                                      'Convergence tuning configurations')
    group.add_argument('--lr_schedule', type=str, default=None,
                       help='LR schedule for training.')
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_momentum", type=bool, default=False)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    group.add_argument('--warmup_min_lr', type=float, default=0)
    group.add_argument('--warmup_max_lr', type=float, default=0.001)
    group.add_argument('--warmup_num_steps', type=int, default=1000)
    return parser


def parse_arguments():
    parser = argparse.ArgumentParser()
    parser = add_tuning_arguments(parser)
    lr_sched_args, unknown_args = parser.parse_known_args()
    return lr_sched_args, unknown_args


def get_config_from_args(args):
    if not hasattr(args, LR_SCHEDULE) or args.lr_schedule is None:
        return None, '--{} not specified on command line'.format(LR_SCHEDULE)
    if args.lr_schedule not in VALID_LR_SCHEDULES:
        return None, '{} is not supported LR schedule'.format(args.lr_schedule)

    config = {'type': args.lr_schedule, 'params': {}}
    if args.lr_schedule == LR_RANGE_TEST:
        keys = [LR_RANGE_TEST_MIN_LR, LR_RANGE_TEST_STEP_RATE,
                LR_RANGE_TEST_STEP_SIZE, LR_RANGE_TEST_STAIRCASE]
    elif args.lr_schedule == ONE_CYCLE:
        keys = [CYCLE_MIN_LR, CYCLE_MAX_LR, DECAY_LR_RATE,
                CYCLE_FIRST_STEP_SIZE, CYCLE_FIRST_STAIR_COUNT,
                CYCLE_SECOND_STEP_SIZE, CYCLE_SECOND_STAIR_COUNT,
                DECAY_STEP_SIZE, CYCLE_MIN_MOM, CYCLE_MAX_MOM, DECAY_MOM_RATE]
    else:
        keys = [WARMUP_MIN_LR, WARMUP_MAX_LR, WARMUP_NUM_STEPS]
        if args.lr_schedule == WARMUP_DECAY_LR:
            keys.append(TOTAL_NUM_STEPS)
    for key in keys:
        if hasattr(args, key):
            config['params'][key] = getattr(args, key)
    return config, None


class _OptimizerShim:
    """Minimal optimizer-like object with `param_groups` for schedulers
    operating standalone (the engine passes its own shim)."""

    def __init__(self, lr=0.0, momentum=0.9, betas=(0.9, 0.999)):
        self.param_groups = [{'lr': lr, 'momentum': momentum, 'betas': betas}]


def get_lr_compatible_optimizer(optimizer):
    if optimizer is None:
        return _OptimizerShim()
    if hasattr(optimizer, 'param_groups'):
        return optimizer
    raise TypeError(f'{type(optimizer).__name__} is not an Optimizer')


class _BaseSchedule:
    """Shared step/state_dict plumbing for all schedules."""

    def __init__(self, optimizer, last_batch_iteration=-1):
        self.optimizer = get_lr_compatible_optimizer(optimizer)
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        raise NotImplementedError

    def get_last_lr(self):
        assert getattr(self, '_last_lr', None) is not None, \
            "need to call step() first"
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        for param_group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            param_group['lr'] = lr
        self._last_lr = [group['lr'] for group in self.optimizer.param_groups]

    def state_dict(self):
        return {'last_batch_iteration': self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd['last_batch_iteration']

    def _format_param(self, optimizer, param_value, param_name):
        if isinstance(param_value, (list, tuple)):
            if len(param_value) != len(optimizer.param_groups):
                raise ValueError("expected {} value for {}, got {}".format(
                    len(optimizer.param_groups), param_name, param_value))
            return list(param_value)
        return [param_value] * len(optimizer.param_groups)


class LRRangeTest(_BaseSchedule):
    """LR range test (Smith 2018): lr grows from min_lr by step_rate per
    interval, continuously or staircase."""

    def __init__(self,
                 optimizer,
                 lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = self._format_param(self.optimizer, lr_range_test_min_lr,
                                         'lr_range_test_min_lr')
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.interval_fn = self._staircase_interval if lr_range_test_staircase \
            else self._continuous_interval
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lr)

    def _staircase_interval(self):
        return math.floor(float(self.last_batch_iteration + 1) / self.step_size)

    def _continuous_interval(self):
        return float(self.last_batch_iteration + 1) / self.step_size

    def _get_increase(self):
        return (1 + self.step_rate * self.interval_fn())

    def get_lr(self):
        lr_increase = self._get_increase()
        return [lr_range_test_min_lr * lr_increase
                for lr_range_test_min_lr in self.min_lr]

    def _update_optimizer(self, group_lrs):
        for param_group, lr in zip(self.optimizer.param_groups, group_lrs):
            param_group['lr'] = lr


class OneCycle(_BaseSchedule):
    """1-cycle policy (Smith 2018): lr ramps min→max over the first phase,
    max→min over the second, then decays; momentum cycles inversely."""

    def __init__(self,
                 optimizer,
                 cycle_min_lr,
                 cycle_max_lr,
                 decay_lr_rate=0.,
                 cycle_first_step_size=2000,
                 cycle_second_step_size=None,
                 cycle_first_stair_count=0,
                 cycle_second_stair_count=None,
                 decay_step_size=0,
                 cycle_momentum=True,
                 cycle_min_mom=0.8,
                 cycle_max_mom=0.9,
                 decay_mom_rate=0.,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self._initialize_cycle(cycle_first_step_size, cycle_second_step_size,
                               cycle_first_stair_count,
                               cycle_second_stair_count, decay_step_size)
        self._initialize_lr(self.optimizer, cycle_min_lr, cycle_max_lr,
                            decay_lr_rate, last_batch_iteration)
        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            self._initialize_momentum(self.optimizer, cycle_min_mom,
                                      cycle_max_mom, decay_mom_rate,
                                      last_batch_iteration)

    def _initialize_cycle(self, cycle_first_step_size, cycle_second_step_size,
                          cycle_first_stair_count, cycle_second_stair_count,
                          decay_step_size):
        cycle_first_step_size = float(cycle_first_step_size)
        cycle_second_step_size = float(cycle_second_step_size) \
            if cycle_second_step_size is not None else cycle_first_step_size

        self.total_size = cycle_first_step_size + cycle_second_step_size
        self.step_ratio = cycle_first_step_size / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = cycle_first_stair_count \
            if cycle_second_stair_count is None else cycle_second_stair_count
        self.decay_step_size = decay_step_size

    def _initialize_lr(self, optimizer, cycle_min_lr, cycle_max_lr,
                       decay_lr_rate, last_batch_iteration):
        self.min_lrs = [cycle_min_lr] * len(optimizer.param_groups)
        if last_batch_iteration == -1:
            for lr, group in zip(self.min_lrs, optimizer.param_groups):
                group['lr'] = lr
        self.max_lrs = [cycle_max_lr] * len(optimizer.param_groups)
        self.decay_lr_rate = decay_lr_rate

    def _initialize_momentum(self, optimizer, cycle_min_mom, cycle_max_mom,
                             decay_mom_rate, last_batch_iteration):
        if 'betas' not in optimizer.param_groups[0] and \
                'momentum' not in optimizer.param_groups[0]:
            optimizer_name = type(optimizer).__name__
            logger.warning(
                f"cycle_momentum is disabled because optimizer "
                f"{optimizer_name} does not support momentum")
            self.cycle_momentum = False
            return
        self.decay_mom_rate = decay_mom_rate
        self.min_moms = [(cycle_min_mom, 0.99)] * len(optimizer.param_groups)
        self.max_moms = [(cycle_max_mom, 0.99)] * len(optimizer.param_groups)
        if last_batch_iteration == -1:
            for momentum, group in zip(self.min_moms, optimizer.param_groups):
                group['betas'] = momentum

    def _get_scale_factor(self):
        batch_iteration = (self.last_batch_iteration + 1)
        cycle = math.floor(1 + batch_iteration / self.total_size)
        x = 1. + batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            scale_factor = x / self.step_ratio
        else:
            scale_factor = (x - 1) / (self.step_ratio - 1)
        return scale_factor

    def _get_cycle_mom(self):
        scale_factor = self._get_scale_factor()
        momentums = []
        for base_betas, max_betas in zip(self.min_moms, self.max_moms):
            cycle_min_mom = base_betas[0]
            cycle_max_mom = max_betas[0]
            base_height = (cycle_max_mom - cycle_min_mom) * scale_factor
            momentum = cycle_max_mom - base_height
            momentums.append((momentum, base_betas[1]))
        return momentums

    def _get_cycle_lr(self):
        scale_factor = self._get_scale_factor()
        lrs = []
        for cycle_min_lr, cycle_max_lr in zip(self.min_lrs, self.max_lrs):
            base_height = (cycle_max_lr - cycle_min_lr) * scale_factor
            lr = cycle_min_lr + base_height
            lrs.append(lr)
        return lrs

    def _get_decay_mom(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        mom_decay_factor = (1 + self.decay_mom_rate * decay_interval)
        return [(beta0 * mom_decay_factor, beta1)
                for beta0, beta1 in self.max_moms]

    def _get_decay_lr(self, decay_batch_iteration):
        decay_interval = decay_batch_iteration / self.decay_step_size
        lr_decay_factor = (1 + self.decay_lr_rate * decay_interval)
        return [cycle_min_lr / lr_decay_factor for cycle_min_lr in self.min_lrs]

    def get_lr(self):
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size + 1)

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_mom()
        return self._get_decay_mom(self.last_batch_iteration - self.total_size + 1)

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        for param_group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            param_group['lr'] = lr
        self._last_lr = [group['lr'] for group in self.optimizer.param_groups]
        if self.cycle_momentum:
            momentums = self.get_mom()
            for param_group, momentum in zip(self.optimizer.param_groups,
                                             momentums):
                param_group['betas'] = momentum


class WarmupLR(_BaseSchedule):
    """Log-warmup from min_lr to max_lr over warmup_num_steps, then flat."""

    def __init__(self,
                 optimizer,
                 warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lrs = self._format_param(self.optimizer, warmup_min_lr,
                                          "min_lr")
        self.max_lrs = self._format_param(self.optimizer, warmup_max_lr,
                                          "max_lr")
        self.delta_lrs = [big - small
                          for big, small in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def get_lr(self):
        if self.last_batch_iteration < 0:
            logger.warning("Attempting to get learning rate from scheduler "
                           "before it has started")
            return [0.0]
        gamma = self._get_gamma()
        return [min_lr + (delta_lr * gamma)
                for min_lr, delta_lr in zip(self.min_lrs, self.delta_lrs)]

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * \
                math.log(self.last_batch_iteration + 1)
        return 1.0


def device_schedule_fn(name, params=None, base_lr=None):
    """Step-indexed schedule `lr(step)` -> fp32 tensor, on `step`'s
    device when `step` is a tensor.

    `step` is the count of prior optimizer steps, which equals the host
    scheduler's `last_batch_iteration` at lr-evaluation time (the host
    path calls `step()`, -1 -> 0 on the first step, before reading the
    lr). name=None returns a constant-`base_lr` schedule (or None when
    base_lr is None). `params` uses the JSON scheduler-param keys;
    defaults match the host classes.
    """
    if name is None:
        if base_lr is None:
            return None
        const = float(base_lr)
        return lambda step: torch.full(_shape(step), const,
                                       dtype=torch.float32,
                                       device=_device(step))
    if name not in VALID_LR_SCHEDULES:
        raise ValueError(f"Unknown scheduler {name}")
    p = dict(params or {})

    if name == LR_RANGE_TEST:
        min_lr = float(p.get(LR_RANGE_TEST_MIN_LR, 1e-3))
        step_size = float(p.get(LR_RANGE_TEST_STEP_SIZE, 2000))
        step_rate = float(p.get(LR_RANGE_TEST_STEP_RATE, 1.0))
        staircase = bool(p.get(LR_RANGE_TEST_STAIRCASE, False))

        def lr_range_test(step):
            interval = (_f32(step) + 1.0) / step_size
            if staircase:
                interval = torch.floor(interval)
            return min_lr * (1.0 + step_rate * interval)
        return lr_range_test

    if name == ONE_CYCLE:
        cycle_min_lr = float(p[CYCLE_MIN_LR])
        cycle_max_lr = float(p[CYCLE_MAX_LR])
        decay_lr_rate = float(p.get(DECAY_LR_RATE, 0.0))
        first = float(p.get(CYCLE_FIRST_STEP_SIZE, 2000))
        second = p.get(CYCLE_SECOND_STEP_SIZE)
        second = float(second) if second is not None else first
        total_size = first + second
        step_ratio = first / total_size
        # the decay branch divides by decay_step_size; it is selected
        # only past total_size, where the host class needs it positive
        decay_div = max(float(p.get(DECAY_STEP_SIZE, 0)), 1.0)

        def one_cycle(step):
            step = _f32(step)
            bi = step + 1.0
            cycle = torch.floor(1.0 + bi / total_size)
            x = 1.0 + bi / total_size - cycle
            scale = torch.where(x <= step_ratio, x / step_ratio,
                                (x - 1.0) / (step_ratio - 1.0))
            cycle_lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * scale
            decay_interval = (step - total_size + 1.0) / decay_div
            decay_lr = cycle_min_lr / (1.0 + decay_lr_rate * decay_interval)
            return torch.where(step < total_size, cycle_lr, decay_lr)
        return one_cycle

    # WarmupLR / WarmupDecayLR
    warmup_min_lr = float(p.get(WARMUP_MIN_LR, 0.0))
    warmup_max_lr = float(p.get(WARMUP_MAX_LR, 0.001))
    warmup_num_steps = max(2, int(p.get(WARMUP_NUM_STEPS, 1000)))
    delta_lr = warmup_max_lr - warmup_min_lr
    inv_log_warmup = 1.0 / math.log(warmup_num_steps)
    total_num_steps = int(p[TOTAL_NUM_STEPS]) \
        if name == WARMUP_DECAY_LR else None

    def warmup_lr(step):
        step = _f32(step)
        warm_gamma = inv_log_warmup * torch.log(step + 1.0)
        if total_num_steps is None:
            post = torch.ones_like(step)
        else:
            post = torch.clamp(
                (total_num_steps - step) /
                max(1.0, float(total_num_steps - warmup_num_steps)),
                min=0.0)
        gamma = torch.where(step < warmup_num_steps, warm_gamma, post)
        return warmup_min_lr + delta_lr * gamma
    return warmup_lr


def _shape(step):
    return tuple(step.shape) if isinstance(step, torch.Tensor) else ()


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else None


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32, device=_device(step))


class WarmupDecayLR(WarmupLR):
    """WarmupLR followed by linear decay to 0 at total_num_steps."""

    def __init__(self,
                 optimizer,
                 total_num_steps: int,
                 warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000,
                 last_batch_iteration: int = -1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning(
                'total_num_steps {} is less than warmup_num_steps {}'.format(
                    total_num_steps, warmup_num_steps))

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * \
                math.log(self.last_batch_iteration + 1)
        return max(
            0.0,
            float(self.total_num_steps - self.last_batch_iteration) /
            float(max(1.0, self.total_num_steps - self.warmup_num_steps)))
