"""Sharding policy, axis environment, parameter construction and tree
helpers: the counterpart of ``repro/models/common.py``.

Design (the reference's, DESIGN.md §5):
  * mesh axes: ``("data", "model")`` for a pod, ``("pod", "data", "model")``
    across pods. Parameters never shard over "pod"; the batch shards over
    ("pod", "data").
  * parameters are FSDP-sharded over "data" on their d_model-sized dim and
    tensor-sharded over "model" on their heads / ffn / experts / vocab dim.
    ZeRO-3: a layer's weights are gathered over "data" just before the layer
    uses them and their gradients reduce-scattered back
    (``gather_param``).
  * archs whose head counts the model axis does not divide (starcoder2: 36,
    whisper: 20) go sequence-parallel; the tiny archs (mamba2-130m,
    gpt2-124m) take the "fsdp_only" profile, with the model axis a batch
    axis or computing replicated.

A spec is a tuple with one entry a tensor dim: None, an axis name, or a
tuple of axis names, normalised as jax's ``PartitionSpec`` (a tuple of one
name is that name), so that a spec tree compares equal, leaf by leaf, to the
reference's. ``placements`` turns a spec into ``DTensor`` placements on a
``DeviceMesh``.

On one device (``AxisEnv`` without a mesh, the default) nothing is sharded:
``ParamBuilder`` draws plain tensors on ``device`` and keeps each leaf's
spec beside it. With a mesh (``AxisEnv.from_mesh``) each parameter is a
``DTensor``; on a real process group the full tensor is drawn and
distributed, so a sharded model holds the same values as an unsharded one of
the same seed; on the dry run's fake world each rank draws only its own
shard. Names, shapes, stacking and init scales are the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def to_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (config strings) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU; asking
    for CUDA without a card raises here instead of degrading."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return device


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def pspec(*entries) -> Tuple:
    """A partition spec as a tuple, normalised as jax's ``PartitionSpec``:
    an axis tuple of one name becomes that name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# axis environment
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AxisEnv:
    """Logical -> physical mesh-axis mapping for one mesh. ``mesh`` is the
    ``DeviceMesh`` the model runs on, or None for specs alone (and for one
    device)."""
    mesh_axes: Tuple[str, ...]           # e.g. ("pod", "data", "model")
    axis_sizes: Dict[str, int] = field(default_factory=dict)
    mesh: Any = field(default=None, compare=False, repr=False)

    @property
    def fsdp(self) -> str:
        return "data"

    @property
    def tp(self) -> str:
        return "model"

    @property
    def has_pod(self) -> bool:
        return "pod" in self.mesh_axes

    def batch_axes(self, global_batch: int) -> Optional[Tuple[str, ...]]:
        """Largest prefix of ("pod","data") that evenly divides the batch."""
        axes: Tuple[str, ...] = ("pod", "data") if self.has_pod else ("data",)
        size = math.prod(self.axis_sizes[a] for a in axes)
        if global_batch % size == 0:
            return axes
        if "data" in axes and global_batch % self.axis_sizes["data"] == 0:
            return ("data",)
        return None  # replicate (e.g. long_500k batch=1)

    def batch_axes_joint(self, global_batch: int) -> Optional[Tuple[str, ...]]:
        """Largest divisible prefix of ("pod","data","model"), for the
        fsdp_only profile, where the model axis carries no tensor
        parallelism and would otherwise replicate every activation."""
        base = ("pod", "data", "model") if self.has_pod else ("data", "model")
        for end in range(len(base), 0, -1):
            axes = base[:end]
            size = math.prod(self.axis_sizes[a] for a in axes)
            if global_batch % size == 0:
                return axes
        return None

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_sizes.values())

    @property
    def sharded(self) -> bool:
        """True when the model runs on a mesh of more than one device."""
        return self.mesh is not None and self.n_devices > 1

    @staticmethod
    def from_mesh(mesh) -> "AxisEnv":
        names = tuple(mesh.mesh_dim_names)
        return AxisEnv(names, {a: int(s) for a, s in zip(names, mesh.shape)},
                       mesh)


def host_axis_env(model_parallel: int = 1) -> AxisEnv:
    """Single-host env for smoke tests (1 device)."""
    return AxisEnv(("data", "model"), {"data": 1, "model": model_parallel})


# ---------------------------------------------------------------------------
# sharding policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardingPolicy:
    profile: str            # "tp" | "fsdp_only"
    head_sharded: bool      # q-heads divisible by model axis
    kv_sharded: bool        # kv-heads divisible by model axis
    vocab_sharded: bool
    ffn_sharded: bool
    experts_sharded: bool
    ssm_sharded: bool       # ssm heads divisible
    seq_parallel_attn: bool # used when heads are not shardable
    seq_residuals: bool = False  # Megatron SP: S-sharded layer boundaries

    @property
    def seq_sharded_acts(self) -> bool:
        return self.seq_parallel_attn or self.seq_residuals


def make_policy(cfg: ModelConfig, env: AxisEnv) -> ShardingPolicy:
    tp = env.size(env.tp)
    if cfg.name in ("mamba2-130m", "gpt2-124m") and tp > 1:
        profile = "fsdp_only"
    else:
        profile = "tp"
    if profile == "fsdp_only" or tp == 1:
        return ShardingPolicy(profile, False, False, False, False, False,
                              False, False, False)
    head_ok = cfg.num_heads > 0 and cfg.num_heads % tp == 0
    kv_ok = cfg.num_kv_heads > 0 and cfg.num_kv_heads % tp == 0
    vocab_ok = cfg.vocab_size % tp == 0
    ffn_ok = cfg.d_ff > 0 and cfg.d_ff % tp == 0
    exp_ok = cfg.num_experts > 0 and cfg.num_experts % tp == 0
    ssm_ok = cfg.ssm_state > 0 and cfg.ssm_heads % tp == 0
    seq_par = cfg.num_heads > 0 and not head_ok
    if seq_par:
        # sequence-parallel archs keep activations S-sharded over "model";
        # weights stay data-FSDP only so every product is token-local
        kv_ok = vocab_ok = ffn_ok = False
    return ShardingPolicy(profile, head_ok, kv_ok, vocab_ok, ffn_ok, exp_ok,
                          ssm_ok, seq_par,
                          seq_residuals=cfg.seq_shard_residuals and not seq_par)


def role_axis(role: str, pol: ShardingPolicy, env: AxisEnv):
    """Mesh axis (or None) for a logical dim role."""
    if pol.profile == "fsdp_only":
        return (env.fsdp, env.tp) if role == "d_fsdp" else None
    table = {
        "d_fsdp": env.fsdp,
        "vocab": env.tp if pol.vocab_sharded else None,
        "qout": env.tp if pol.head_sharded else None,
        "kvout": env.tp if pol.kv_sharded else None,
        "ffn": env.tp if pol.ffn_sharded else None,
        "experts": env.tp if pol.experts_sharded else None,
        "ssm_inner": env.tp if pol.ssm_sharded else None,
        "none": None,
    }
    return table[role]


def spec_of(roles: Tuple[str, ...], pol: ShardingPolicy, env: AxisEnv) -> Tuple:
    return pspec(*[role_axis(r, pol, env) for r in roles])


def placements(spec: Tuple, env: AxisEnv) -> Tuple:
    """``DTensor`` placements of ``spec`` on ``env``'s mesh: each mesh axis a
    tensor dim is split over is ``Shard(dim)``, every other axis
    ``Replicate()``. A dim split over several axes is split in mesh order,
    outermost first, as the reference's axis tuples are."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(env.mesh_axes)
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            out[env.mesh_axes.index(axis)] = Shard(dim)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(x):
    """A ``DTensor``'s local shard (autograd-transparent); any other value
    as it is."""
    return x.to_local() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------
class ParamBuilder:
    """Builds parallel (params, specs) nested dicts: ``specs`` holds each
    leaf's partition spec under ``pol`` and ``env`` (default: one device,
    ``host_axis_env``).

    ``env`` with a mesh (``env.sharded``) makes each leaf a ``DTensor`` with
    the spec's placements. On a real process group the full tensor is drawn
    by the same generator call as on one device and then distributed, so
    the values are the unsharded build's. On the dry run's fake world
    (``launch.mesh.fake_world``) each leaf is drawn as this rank's local
    shard only: the full tensor is never made (llama3-8b's 16 GB would be
    drawn for a 63 MB shard).

    ``placement`` (leaf path -> memory kind, as ``core.offload.
    param_placement`` gives it from an offload plan) draws each leaf
    straight into its tier on a CUDA device: a host leaf is drawn by the
    same generator call on the device, copied into a pinned host buffer and
    its device copy freed before the next leaf, and a zeros / ones leaf is
    filled where it lives. Leaves come in the same order from the same
    generator calls, so the result is bit for bit an unplaced build moved
    by ``place_tree``, and the device holds at most the resident leaves and
    one host leaf in flight. On the CPU both tiers are one memory and the
    placement changes nothing. On a mesh a host leaf is drawn as any other
    (the full tensor distributed on a real group, the local shard alone on
    the fake world) and this rank's stored shard is then copied to pinned
    memory, a ``DTensor`` over that host-tier local tensor
    (``shard_local``): the values stay the unplaced build's."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device: torch.device, *, abstract: bool = False,
                 placement: Optional[Dict[str, str]] = None,
                 prefix: str = "", pol: Optional[ShardingPolicy] = None,
                 env: Optional[AxisEnv] = None):
        self.cfg = cfg
        self.generator = generator
        self.device = torch.device("meta") if abstract else device
        self.abstract = abstract
        self.placement = placement
        self.prefix = prefix
        self.env = env if env is not None else host_axis_env()
        self.pol = pol if pol is not None else make_policy(cfg, self.env)
        self.params: Dict[str, Any] = {}
        self.specs: Dict[str, Any] = {}

    def _on_host(self, name: str) -> bool:
        if self.placement is None:
            return False
        from repro_torch.core.offload import PINNED_HOST_KIND
        kind = self.placement[self.prefix + name]
        return self.device.type == "cuda" and kind == PINNED_HOST_KIND

    def _draw(self, shape, dtype, init: str, scale: float):
        arr = torch.empty(shape, dtype=dtype, device=self.device)
        if init in ("zeros", "ones"):
            return arr.fill_(0 if init == "zeros" else 1)
        return arr.normal_(0.0, scale, generator=self.generator)

    def _sharded(self, shape, dtype, init: str, scale: float, spec,
                 host: bool):
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        from repro_torch.launch.mesh import is_fake_world
        mesh, pl = self.env.mesh, placements(spec, self.env)
        if not is_fake_world():
            arr = distribute_tensor(self._draw(shape, dtype, init, scale),
                                    mesh, pl)
        else:
            local_shape, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                                   pl)
            arr = shard_local(self._draw(local_shape, dtype, init, scale),
                              shape, pl, mesh)
        if not host:
            return arr
        from repro_torch.core.offload import to_host
        return shard_local(to_host(arr.to_local(), self.device), shape, pl,
                           mesh)

    def add(self, name: str, shape: Tuple[int, ...], roles: Tuple[str, ...],
            *, scale: Optional[float] = None, init: str = "normal"):
        assert len(shape) == len(roles), (name, shape, roles)
        dtype = to_dtype(self.cfg.param_dtype)
        spec = spec_of(roles, self.pol, self.env)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        host = not self.abstract and self._on_host(name)
        if self.abstract:
            arr = torch.empty(shape, dtype=dtype, device="meta")
        elif self.env.sharded:
            arr = self._sharded(shape, dtype, init, scale, spec, host)
        elif host and init in ("zeros", "ones"):
            from repro_torch.core.offload import empty_host
            arr = empty_host(shape, dtype, self.device)
            arr.fill_(0 if init == "zeros" else 1)
        else:
            arr = self._draw(shape, dtype, init, scale)
            if host:
                from repro_torch.core.offload import to_host
                arr = to_host(arr, self.device)
        self.params[name] = arr
        self.specs[name] = spec

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.cfg, self.generator, self.device,
                           abstract=self.abstract, placement=self.placement,
                           prefix=f"{self.prefix}{name}/", pol=self.pol,
                           env=self.env)
        self.params[name] = sub.params
        self.specs[name] = sub.specs
        return sub


# ---------------------------------------------------------------------------
# running on a mesh: ZeRO-3 gathers and the tensor-parallel region
#
# The model's activations are local tensors, each rank's shard. A parameter
# (a DTensor) is gathered just before its layer uses it; the helpers below
# move activations between layouts with DTensor's collectives, whose
# backward is autograd's, so every gradient lands in its parameter's
# placements.
# ---------------------------------------------------------------------------
def gather_param(w, env: AxisEnv, pol: ShardingPolicy, *, partial_axes=(),
                 dtype: Optional[torch.dtype] = None, whole: bool = False):
    """The local tensor a layer computes with, from parameter ``w``: every
    mesh axis ``w`` is sharded over is all-gathered, except the model axis
    of the "tp" profile, whose shard stays (tensor parallelism) unless
    ``whole`` asks for the whole tensor (a rank that computes with columns
    of other ranks' shards). ``dtype`` casts before the gather, so the
    gather moves the compute dtype.

    In the backward the local gradient is declared ``Partial`` over
    ``partial_axes`` (the axes whose ranks each hold a part of the sum: the
    batch axes, and the model axis for a weight inside the
    tensor-parallel region that each model rank uses on its own heads) and
    ``Replicate`` over the rest; DTensor then reduce-scatters it back to
    ``w``'s placements (ZeRO-3). A plain tensor (one device) is returned as
    it is, cast.

    A host-tier shard (``on_host``: pinned host memory beside a CUDA mesh)
    is gathered on the device: a collective cannot read pinned memory, so
    the shard is copied over first (``gather_param.h2d_bytes`` counts those
    bytes), then cast and gathered there, as the reference's memory kind
    belongs to the stored shard. Where nothing is gathered, the pinned local
    shard is returned as it is, neither cast nor copied on the host, for
    ``weight_matmul`` to stream (the "tp" profile with every other axis of
    size 1)."""
    if not is_dtensor(w):
        return w if dtype is None else w.to(dtype)
    from torch.distributed.tensor import Partial, Replicate
    target, grad = [], []
    for axis, p in zip(env.mesh_axes, w.placements):
        keep = (p.is_shard() and axis == env.tp and pol.profile == "tp"
                and not whole)
        target.append(p if keep else Replicate())
        if keep:
            grad.append(p)
        elif axis in partial_axes and env.size(axis) > 1:
            grad.append(Partial())
        else:
            grad.append(Replicate())
    if on_host(w):
        if all(t == p or env.size(a) == 1
               for a, t, p in zip(env.mesh_axes, target, w.placements)):
            return w.to_local()
        shard = w.to_local().to(env.mesh.device_type, non_blocking=True)
        gather_param.h2d_bytes += shard.numel() * shard.element_size()
        w = shard_local(shard, w.shape, w.placements, env.mesh)
    if dtype is not None:
        w = w.to(dtype)
    return w.redistribute(env.mesh, tuple(target)).to_local(
        grad_placements=tuple(grad))


gather_param.h2d_bytes = 0


def layer_of(w, i: int):
    """Layer ``i`` of a layer-stacked parameter, ``w[i]``; of a host-tier
    shard, the layer of its local shard, left where it is (the stacking dim
    is never split)."""
    if not on_host(w):
        return w[i]
    from torch.distributed.tensor import Shard
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in w.placements)
    return shard_local(w.to_local()[i], w.shape[1:], pl, w.device_mesh)


def on_host(w) -> bool:
    """True for a ``DTensor`` whose local shard lies apart from its mesh's
    device: a host-tier parameter or pool leaf of an offload plan, in
    pinned host memory beside a CUDA mesh. (Read on the local tensor
    itself: ``to_local`` would be an autograd node on every gather.)"""
    return (is_dtensor(w)
            and w._local_tensor.device.type != w.device_mesh.device_type)


def with_axis(pl, env: AxisEnv, axis: str, placement):
    return tuple(placement if a == axis else p
                 for a, p in zip(env.mesh_axes, pl))


def global_shape(x, env: AxisEnv, pl, seq_len: Optional[int] = None,
                 seq_dim: int = 1) -> Tuple[int, ...]:
    """The global shape of the tensor laid out by placements ``pl`` whose
    local shard on this rank is ``x``: a dim split over mesh axes is the
    local size times theirs (the batch splits evenly), except the sequence
    dim ``seq_dim``, whose global length ``seq_len`` is given (a split of
    1,500 encoder frames over 16 ranks leaves 94 on fifteen and 90 on the
    last, as ``torch.chunk`` does)."""
    shape = list(x.shape)
    for axis, p in zip(env.mesh_axes, pl):
        if p.is_shard():
            if p.dim == seq_dim and seq_len is not None:
                shape[seq_dim] = seq_len
            else:
                shape[p.dim] *= env.size(axis)
    return tuple(shape)


def dtensor_of(x, env: AxisEnv, pl, seq_len: Optional[int] = None):
    from torch.distributed.tensor import DTensor
    shape = global_shape(x, env, pl, seq_len)
    return DTensor.from_local(x, env.mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def tp_enter(x, env: AxisEnv, act_pl, seq_len: Optional[int] = None):
    """Entry of the tensor-parallel region (Megatron's f): the identity
    forward; the gradient, a part per model rank, is all-reduced over the
    model axis. ``act_pl``: the activation's placements. Where they split
    the sequence (dim 1, ``seq_len`` long) over the model axis, the entry is
    Megatron's sequence-parallel one instead: an all-gather of the sequence
    over the model axis, whose backward reduce-scatters the ranks' parts of
    the gradient back to the split. The same gather brings a
    sequence-parallel rank the whole sequence's keys and values."""
    from torch.distributed.tensor import Partial, Replicate
    d = dtensor_of(x, env, act_pl, seq_len)
    whole = with_axis(act_pl, env, env.tp, Replicate())
    if tuple(whole) != tuple(act_pl):
        d = d.redistribute(env.mesh, whole)
    return d.to_local(grad_placements=with_axis(act_pl, env, env.tp,
                                                 Partial()))


def gather_whole(x, env: AxisEnv, act_pl, seq_len: Optional[int] = None):
    """The sequence, split over the model axis by ``act_pl``, all-gathered
    whole, as ``tp_enter``'s gather, for a computation that every model
    rank then repeats on the whole sequence (the MoE routing): its gradient
    is the same on every rank, so it is declared ``Replicate`` and the
    backward takes this rank's slice of it instead of reduce-scattering the
    ranks' sum."""
    from torch.distributed.tensor import Replicate
    d = dtensor_of(x, env, act_pl, seq_len)
    whole = with_axis(act_pl, env, env.tp, Replicate())
    return d.redistribute(env.mesh, whole).to_local(grad_placements=whole)


def tp_exit(x, env: AxisEnv, act_pl):
    """Exit of the tensor-parallel region (Megatron's g): the model ranks'
    partial sums all-reduced over the model axis; the identity backward.
    Where ``act_pl`` splits the sequence over the model axis (Megatron's
    sequence parallelism), a reduce-scatter to that split instead, whose
    backward is the all-gather."""
    from torch.distributed.tensor import DTensor, Partial
    part = DTensor.from_local(x, env.mesh,
                              with_axis(act_pl, env, env.tp, Partial()),
                              run_check=False)
    return part.redistribute(env.mesh, act_pl).to_local()


def model_sum(x, env: AxisEnv, act_pl):
    """The sum over the model axis of every model rank's ``x`` (laid out by
    placements ``act_pl`` over the other axes), on every model rank: the
    all-reduce forward, and an all-reduce of the ranks' gradients backward,
    since every rank's result feeds that rank's own part of the loss. A
    statistic over a dim that the model axis splits (the SSM's gated norm
    over ``d_inner``) takes it; ``tp_exit``'s backward is the identity
    instead, for a sum the ranks then use as one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    part = with_axis(act_pl, env, env.tp, Partial())
    d = DTensor.from_local(x, env.mesh, part, run_check=False)
    return d.redistribute(env.mesh, with_axis(act_pl, env, env.tp, Replicate())
                          ).to_local(grad_placements=part)


def shard_local(x, shape, pl, mesh):
    """The ``DTensor`` of global ``shape`` laid out by placements ``pl`` on
    ``mesh`` whose local shard on this rank is ``x`` (no communication). A
    shard on another device than the mesh's (a host-tier shard in pinned
    memory beside a CUDA mesh) stays where it is, where
    ``DTensor.from_local`` would copy it to the mesh's device."""
    from torch.distributed.tensor import DTensor
    meta = dict(run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
    if x.device.type in (mesh.device_type, "meta"):
        return DTensor.from_local(x, mesh, pl, **meta)
    like = DTensor.from_local(x.to("meta"), mesh, pl, **meta)
    return DTensor(x, like._spec, requires_grad=False)


def lay_local(x, spec, env: AxisEnv):
    """The ``DTensor`` laid out by ``spec`` on ``env``'s mesh from ``x``,
    the whole tensor, the same on every rank: each rank keeps its own slice
    (no communication; an uneven split as ``torch.chunk`` cuts it)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl = placements(spec, env)
    shape, offset = compute_local_shape_and_global_offset(x.shape, env.mesh,
                                                          pl)
    part = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return shard_local(part, x.shape, pl, env.mesh)


def reshard(x, env: AxisEnv, src_pl, dst_pl):
    """Local tensor ``x`` laid out by ``src_pl`` -> the local tensor of the
    same global tensor laid out by ``dst_pl`` (DTensor's collectives; a
    split of a replicated dim is a local slice whose backward gathers)."""
    from torch.distributed.tensor import DTensor
    d = DTensor.from_local(x, env.mesh, src_pl, run_check=False)
    return d.redistribute(env.mesh, dst_pl).to_local()


# ---------------------------------------------------------------------------
# using a parameter wherever the offload plan placed it
# ---------------------------------------------------------------------------
def weight_matmul(x, w):
    """``x @ w`` for a weight in either tier. On x's device it is the
    reference's ``x @ w.astype(x.dtype)``. A weight left in (pinned) host
    memory beside CUDA activations is streamed through the ``stream_matmul``
    kernel with x flattened to 2-D: it is neither cast on the host nor copied
    whole, and its bytes cross the host link once per call. The route
    follows where the tensor lives; the wrapper raises on what it cannot
    stream (e.g. pageable host memory). The kernel has no backward, so a
    streamed product that autograd would differentiate raises instead of
    losing the gradient.

    A 3-D ``w`` is an expert stack (E, d, f) with x (E, M, d) (any expert
    stride: 0 shares one x among the experts); the product per expert goes
    through ``grouped_matmul``, whose wrapper routes by placement the same
    way: the plain version on the CPU, the kernel on the card for a weight
    on the device or in pinned host memory (streamed), a raise for pageable
    host memory or a gradient wanted through a pinned stack. A stack on x's
    device is cast to x's dtype first, as the reference's einsum on
    ``w.astype(x.dtype)``: fp32 training parameters meet bf16 activations
    as one bf16 product (the ``wgmma`` route), and autograd carries the
    gradient back through the cast. A pinned stack is never cast on the
    host."""
    if w.dim() == 3:
        if w.device == x.device:
            w = w.to(x.dtype)
        return kops.grouped_matmul(x, w)
    if w.device == x.device:
        return x @ w.to(x.dtype)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "a weight placed apart from the activations is streamed through "
            "stream_matmul, which has no backward; training keeps every "
            f"weight on the activations' device (weight on {w.device}, "
            f"activations on {x.device})")
    out = kops.stream_matmul(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# tree helpers (nested dicts of tensors, keys in sorted order as the
# reference's pytree flattening gives them)
# ---------------------------------------------------------------------------
def cdtype(cfg: ModelConfig) -> torch.dtype:
    return to_dtype(cfg.dtype)


def tree_items(tree: PyTree):
    """(path component, child) pairs of one node in the reference's
    flattening order and names: dict keys sorted, NamedTuple fields in order
    as ``.name`` (how jax prints a ``GetAttrKey``), other sequence items by
    index. None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def rebuild(tree: PyTree, children) -> PyTree:
    """A node of ``tree``'s kind from new children in ``tree_items`` order:
    dicts keep ``tree``'s key order, NamedTuples their type."""
    children = list(children)
    if isinstance(tree, dict):
        built = dict(zip(sorted(tree), children))
        return {k: built[k] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def tree_leaves(tree: PyTree):
    items = tree_items(tree)
    if items is None:
        if tree is not None:
            yield tree
        return
    for _, child in items:
        yield from tree_leaves(child)


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """The inverse of ``tree_leaves``: ``like``'s structure (dicts, lists,
    tuples, NamedTuples; None stays None) with ``leaves`` taken in
    ``tree_leaves`` order. Dicts keep ``like``'s key order."""
    return _unflatten(like, iter(leaves))


def _unflatten(like: PyTree, it) -> PyTree:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``leaves`` (a decode tick's
    # materialized KV cache) alive until the garbage collector runs
    items = tree_items(like)
    if items is None:
        return None if like is None else next(it)
    return rebuild(like, (_unflatten(child, it) for _, child in items))


def cast_tree(tree: PyTree, dtype) -> PyTree:
    """Floating leaves cast to ``dtype``; other leaves and the structure kept."""
    dtype = to_dtype(dtype)
    return tree_unflatten(tree, [
        x.to(dtype) if isinstance(x, torch.Tensor) and x.is_floating_point()
        else x for x in tree_leaves(tree)])


def tree_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "dtype"))
