"""The device mesh of multi-device S³ runs.

Port of the JAX package's ``parallel/mesh.py``.  The scale-out axis is the
*cell* axis (points of the indexed cloud, grid cells, snapshot-matrix
rows), split over a 1-D mesh of devices.  One process drives every shard
(the JAX package's single-controller ``shard_map``): a shard's work runs on
its device, and the collectives are small functions on lists of
per-shard tensors in shard order (:func:`all_gather`, :func:`psum`), whose
results land on the mesh's ``root``, the first device, which holds the
replicated state.  On distinct cards they are peer copies.

Two module attributes choose the mesh, as ``SamplingTree.DEVICE_LOOP``
chooses the adaptive route:

- ``DISABLE_SHARDING`` (the JAX package's ``S3_TPU_DISABLE_SHARDING``):
  True keeps every entry point on one device;
- ``VIRTUAL_SHARDS`` (the JAX package's
  ``--xla_force_host_platform_device_count``): an int gives a mesh of that
  many shards on the one device the caller asked for; a list of devices
  gives one shard on each, in order (a mesh such as ``[cuda:0, cpu]``, on
  which an operation that mixes devices without an explicit move fails).

With both at their defaults, sharding is on where more than one card of
the caller's device type is visible, and a machine with one card, or the
CPU, takes the single-device path.
"""
import numpy as np
import torch

from .._device import resolve_device

CELL_AXIS = "cells"
# True keeps every entry point on one device
DISABLE_SHARDING = False
# None, an int (shards on the caller's device) or a list of devices
VIRTUAL_SHARDS = None


class Mesh:
    """An ordered 1-D mesh of torch devices along ``CELL_AXIS``; a device
    may carry several shards.  ``root`` (the first) holds the replicated
    state and the results of the collectives."""

    def __init__(self, devices):
        self.devices = tuple(_concrete(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def _concrete(dev: torch.device) -> torch.device:
    """``cuda`` with its index (the current card when none is given), so
    that two names of one card compare equal."""
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
    return dev


def sharding_enabled(device=None) -> bool:
    """True when the entry points should shard their hot paths (the kNN
    epochs, the export's weights and interpolation, the randomized SVD):
    a virtual mesh is set, or more than one card of ``device``'s type is
    visible; never while ``DISABLE_SHARDING`` is set."""
    if DISABLE_SHARDING:
        return False
    if VIRTUAL_SHARDS is not None:
        return True
    dev = resolve_device(device)
    return dev.type == "cuda" and torch.cuda.device_count() > 1


def make_mesh(n_devices: int = None, device=None) -> Mesh:
    """A mesh for the caller's ``device`` (None means the card): the
    ``VIRTUAL_SHARDS`` mesh where that is set (``n_devices`` shards, if
    given, on the caller's device), else one shard on each of the first
    ``n_devices`` cards (default: every visible card), or ``n_devices``
    shards on the CPU.  Raises where the mesh cannot be built."""
    if isinstance(VIRTUAL_SHARDS, (list, tuple)):
        return Mesh(VIRTUAL_SHARDS)
    dev = _concrete(resolve_device(device))
    if VIRTUAL_SHARDS is not None or dev.type != "cuda":
        n = n_devices if n_devices is not None else (VIRTUAL_SHARDS or 1)
        if int(n) < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return Mesh([dev] * int(n))
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(f"a mesh of {n} cards needs them visible; "
                         f"{visible} are")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def default_mesh(device=None) -> Mesh:
    return make_mesh(device=device)


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0.0):
    """Pad ``x`` (a numpy array or a tensor) along ``axis`` with ``fill``
    so its size is a multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = pad
        return torch.cat([x, x.new_full(shape, fill)], dim=axis)
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def shard_rows(x, mesh: Mesh) -> list:
    """``x`` cut into ``mesh.size`` equal contiguous row blocks (its rows
    a multiple of the size), block ``s`` on shard ``s``'s device."""
    n = x.shape[0] // mesh.size
    return [x[s * n:(s + 1) * n].to(dev) for s, dev in
            enumerate(mesh.devices)]


def all_gather(parts: list, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The per-shard ``parts`` moved to the root and concatenated along
    ``dim`` in shard order."""
    return torch.cat([p.to(mesh.root) for p in parts], dim=dim)


def psum(parts: list, mesh: Mesh) -> torch.Tensor:
    """The sum of the per-shard ``parts`` on the root, added in shard
    order, so the sum does not depend on which shard finishes first."""
    out = parts[0].to(mesh.root)
    for p in parts[1:]:
        out = out + p.to(mesh.root)
    return out
