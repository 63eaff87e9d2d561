"""Data-parallel training over a mesh, in one process or many: the port of
``annonet_tpu/parallel/train.py``.

The minibatch is split in mesh order over the mesh's shards (a mesh is the
tuple of ``torch.device``s of ``parallel/mesh.py``; virtual shards of one
device work alike). Each shard augments, weighs and forwards its crops on
its device, in one autograd graph:

  * sync BN: at every BN layer each shard's mean and mean square (f32) are
    averaged over all shards (``ShardReducer.mean``), so the step computes
    the single-device step's function on the whole batch (JAX's ``pmean``
    of the statistics inside ``apply_train``);
  * the loss is the mean of the shards' losses (JAX's ``pmean`` before the
    gradient), differentiated once;
  * the parameters have one master copy; each shard reads its own copy of
    it (``shard_params``), its gradient comes back there, and the shards'
    gradients are summed; one SGD update (``trainer._sgd``) on the master
    follows.

Across processes (``annonet_train --coordinator``) every process runs its
local shards so, and the same reductions cross the process group: the BN
moments (forward, and their gradients backward), the int8 activation
abs-max and, after backward, the gradients and the loss. Each is an
all-gather of every shard's term followed by a sum in global shard order
on every process (``ShardReducer``), so one process with 4 shards and 2
processes with 2 shards each compute the same step bit for bit (an
all-reduce would add the processes' partial sums in another order, and
training's ill-conditioned BN layers turn such last-bit differences into
visible ones within a few steps). The group is gloo's; tensors cross it
through host copies.
Every process holds the same minibatch (the deterministic crop stream)
and takes its shards of it, so the parameters stay equal everywhere, and
``io_process`` (rank 0) alone writes files.

Augmentation draws come from one generator per GLOBAL shard index, so one
process with 4 shards draws what 2 processes with 2 shards each draw; the
draws may also be given for the whole batch (a test's seam), and each
shard takes its rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from annonet_tpu_torch.models.segnet import SegNetConfig, tree_items, tree_map
from annonet_tpu_torch.ops.augment import AugmentDraws, draw_augmentations
from annonet_tpu_torch.ops.crop_gather import gather_crops_packed
from annonet_tpu_torch.ops.loss import weighted_pixel_cross_entropy
from annonet_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    _augment_and_weigh,
    _sgd,
    train_forward,
)
from annonet_tpu_torch.utils.profiling import span


def _process_group():
    """The default process group when this process is one of several,
    else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


class ShardReducer:
    """The reductions of a data-parallel step over the local shards
    (``mesh``, on their devices) and, with a process group, over every
    process's shards.

    Every cross-shard sum gathers all shards' terms (across the processes
    too) and adds them one by one in global shard order on every process,
    so the sums, and the step, are bit for bit the same however the mesh
    is split into processes."""

    def __init__(self, mesh: Sequence[torch.device], group=None):
        import torch.distributed as dist

        self.mesh = tuple(torch.device(d) for d in mesh)
        self.home = self.mesh[0]
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        #: shards of the whole mesh, every process's
        self.shards = len(self.mesh) * self.world

    def gather(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's tensor of the mesh, in global shard order, on the
        home device (the local shards give ``tensors``, one each; other
        processes' arrive through a host all-gather: gloo reduces host
        memory). No gradient."""
        local = torch.stack([t.detach().to(self.home) for t in tensors])
        if self.group is None:
            return list(local)
        import torch.distributed as dist

        host = local.to("cpu", copy=True)
        parts = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(parts, host, group=self.group)
        return list(torch.cat(parts).to(self.home))

    def ordered_sum(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard of the mesh, added in global order."""
        terms = self.gather(tensors)
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return total

    def mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over every shard of the local shards' ``tensors``, one
        copy a local shard on its device (differentiable: each shard's
        input receives the mean of every shard's gradient)."""
        return list(_ShardMean.apply(self, *tensors))

    def max(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The element-wise maximum over every shard (no gradient)."""
        return torch.stack(self.gather(tensors)).amax(dim=0)


class _ShardMean(torch.autograd.Function):
    """out_j = (1/S) sum_s x_s for every shard j; backward, every x_s gets
    (1/S) sum_j grad_j, both sums in global shard order."""

    @staticmethod
    def forward(ctx, reducer, *tensors):
        ctx.reducer = reducer
        ctx.devices = [t.device for t in tensors]
        mean = reducer.ordered_sum(list(tensors)) / reducer.shards
        return tuple(mean.to(d, copy=True) for d in ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        reducer = ctx.reducer  # grads are materialised: zeros where unused
        mean = reducer.ordered_sum(list(grads)) / reducer.shards
        return (None, *(mean.to(d) for d in ctx.devices))


def shard_params(params, mesh: Sequence[torch.device]):
    """One copy of the master parameter tree for each local shard, on its
    device, as leaves that require grad: each shard's gradient comes back
    on its own copy, and the step sums them in global shard order."""
    return [tree_map(lambda t, d=d: t.detach().to(d, copy=True).requires_grad_(True), params)
            for d in mesh]


def make_dp_train_step(model_config: SegNetConfig, trainer_config: TrainerConfig,
                       reducer: ShardReducer):
    """The data-parallel step (``make_dp_train_step``):

    (params, bn_stats, velocity, lr, bn_momentum, images, labels, weights)
        -> (new bn_stats, loss on the home device)

    over lists of the local shards' images, labels and weights (each on its
    device), updating the master ``params`` and ``velocity`` in place: the
    loss is the mean of every shard's loss (each shard's gradient seeded
    with 1/S), the gradient the sum of the shards' gradients."""
    mu = trainer_config.momentum
    wd = trainer_config.weight_decay

    def step(params, bn_stats, velocity, lr, bn_momentum, images, labels, weights):
        names = [k for k, _ in tree_items(params)]
        p_leaves = [t for _, t in tree_items(params)]
        v_by_name = dict(tree_items(velocity))
        with span("shard_params"):
            copies = shard_params(params, reducer.mesh)
        with torch.enable_grad():
            logits, new_stats = train_forward(copies, bn_stats, images, model_config,
                                              trainer_config, bn_momentum, reducer)
            with span("loss"):
                losses = [weighted_pixel_cross_entropy(lg, lab, w)
                          for lg, lab, w in zip(logits, labels, weights)]
            with span("backward"):
                leaves = [t for tree in copies for _, t in tree_items(tree)]
                seeds = [torch.full_like(l, 1.0 / reducer.shards) for l in losses]
                grads = torch.autograd.grad(losses, leaves, seeds)
        with torch.no_grad(), span("grad_sum"):
            n = len(p_leaves)
            flat = [torch.cat([g.reshape(-1) for g in grads[i * n:(i + 1) * n]])
                    for i in range(len(copies))]
            total = reducer.ordered_sum(flat)
            sizes = [t.numel() for t in p_leaves]
            summed = [g.reshape(t.shape) for g, t in zip(total.split(sizes), p_leaves)]
            loss = reducer.ordered_sum([l.detach() for l in losses]) / reducer.shards
        with torch.no_grad(), span("sgd"):
            _sgd(p_leaves, [v_by_name[k] for k in names], summed, lr, mu, wd)
        return new_stats, loss

    return step


def _draw_rows(draws: AugmentDraws, start: int, stop: int) -> AugmentDraws:
    """The draws of crops start..stop-1 (every field is one row a crop)."""
    return AugmentDraws(**{
        f.name: None if getattr(draws, f.name) is None else getattr(draws, f.name)[start:stop]
        for f in dataclasses.fields(draws)
    })


class DataParallelTrainer(Trainer):
    """A Trainer whose step runs data-parallel over ``mesh`` (its local
    shards) and, when ``torch.distributed`` is initialised with more than
    one process, over every process's shards. Plateau logic, sync files and
    the exported net are the Trainer's; the master parameters live on
    ``mesh[0]``. The minibatch must divide by the mesh's global shard count
    (the CLI rounds it up)."""

    def __init__(
        self,
        model_config: SegNetConfig,
        trainer_config: TrainerConfig = TrainerConfig(),
        seed: int = 0,
        *,
        mesh: Sequence[torch.device],
    ):
        mesh = tuple(torch.device(d) for d in mesh)
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        super().__init__(model_config, trainer_config, seed=seed, device=mesh[0])
        self.mesh = mesh
        self.reducer = ShardReducer(mesh, _process_group())
        self._dp_step_fn = make_dp_train_step(model_config, trainer_config, self.reducer)
        self._shard_generators: Optional[List[torch.Generator]] = None
        if self.reducer.world > 1:
            self.io_process = self.reducer.rank == 0
            self.sync_flush = False

    @property
    def device_count(self) -> int:
        """The mesh's shards over every process (JAX's batch-axis size)."""
        return self.reducer.shards

    @property
    def pool_replicas(self):
        return self.mesh

    def _local_ranges(self, batch: int):
        """[(start, stop)] of this process's shards in the batch."""
        if batch % self.device_count:
            raise ValueError(
                f"minibatch size {batch} must be divisible by the mesh "
                f"batch-axis size {self.device_count}"
            )
        per = batch // self.device_count
        first = self.reducer.rank * len(self.mesh)
        return [(g * per, (g + 1) * per) for g in range(first, first + len(self.mesh))]

    def _shard_draws(self, seed, i, n, shape, crop_options):
        """Local shard ``i``'s draws from its own generator (on the shard's
        device, seeded from the run's seed and the shard's global index)."""
        if self._shard_generators is None:
            first = self.reducer.rank * len(self.mesh)
            self._shard_generators = []
            for j, device in enumerate(self.mesh):
                gen = torch.Generator(device=device)
                gen.manual_seed((seed ^ 0x5EED) + 0x9E3779B1 * (first + j + 1))
                self._shard_generators.append(gen)
        return draw_augmentations(self._shard_generators[i], n, shape, crop_options)

    def train_step_crops(self, images, labels, crop_options, seed: int = 0,
                         draws: Optional[AugmentDraws] = None):
        """One data-parallel update from raw host crops of the whole
        (global) minibatch; ``draws``, when given, cover it all."""
        images, labels = np.asarray(images), np.asarray(labels)
        xs, labs, ws = [], [], []
        for i, (a, b) in enumerate(self._local_ranges(images.shape[0])):
            device = self.mesh[i]
            x = self._tensor(images[a:b]).to(device)
            lab = self._labels(labels[a:b]).to(device)
            d = (_draw_rows(draws, a, b) if draws is not None else
                 self._shard_draws(seed, i, b - a, tuple(x.shape[1:]), crop_options))
            x, lab, w = _augment_and_weigh(x, lab, crop_options, self.model_config.class_count,
                                           d.to(device), flips_pre_applied=False, timed=False)
            xs.append(x), labs.append(lab), ws.append(w)
        return self._dispatch_dp(xs, labs, ws)

    def train_step_decisions(self, pool, samples, rects, crop_options, seed: int = 0,
                             draws: Optional[AugmentDraws] = None):
        """One data-parallel update from the crop decisions of the whole
        minibatch: each shard gathers its own columns from its device's copy
        of the pool (``DeviceImagePool(..., replicas=trainer.mesh)``)."""
        ranges = self._local_ranges(len(samples))
        dim, packed = self._packed_decisions(pool, samples, rects, crop_options)
        xs, labs, ws = [], [], []
        for i, (a, b) in enumerate(ranges):
            device = self.mesh[i]
            d = (_draw_rows(draws, a, b) if draws is not None else
                 self._shard_draws(seed, i, b - a, (dim, dim, pool.images.shape[-1]),
                                   crop_options)).to(device)
            pool_images, pool_labels = pool.tensors(device)
            with span("gather"):
                x, lab = gather_crops_packed(
                    pool_images, pool_labels, self._tensor(packed[:, a:b]).to(device), dim,
                    flip_lr=d.flip_lr, flip_ud=d.flip_ud,
                )
            x, lab, w = _augment_and_weigh(x, lab, crop_options, self.model_config.class_count,
                                           d, flips_pre_applied=True, timed=False)
            xs.append(x), labs.append(lab), ws.append(w)
        return self._dispatch_dp(xs, labs, ws)

    def _dispatch_dp(self, images, labels, weights):
        self.bn_stats, loss = self._dp_step_fn(
            self.params, self.bn_stats, self.velocity, self.learning_rate,
            self._bn_momentum(), images, labels, weights,
        )
        return self._finish_step(loss)
