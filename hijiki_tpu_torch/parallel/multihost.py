"""Multi-host rendering: whole sweeps strided across processes.

Port of ``hijiki_tpu/parallel/multihost.py`` on ``torch.distributed``.
Within a process, a sweep may shard over its devices
(``parallel/multichip.py``); across processes, host h renders sweeps h,
h + N, h + 2N, ... of the one deterministic schedule (seed = f(user seed,
sweep, block), ``render/blocks.py``), so the union over hosts is exactly
the single-host sample set. Films are (rgb*w, w) running sums, so the
merge is one sum at readback and no sweep communicates.

Without a process group, hosts are simulated by building several
renderers with explicit (host_id, num_hosts) and merging their films with
``merge_films`` (as the tests do). Under ``torch.distributed``, host_id and
num_hosts default to the rank and the world size, and ``merged_film()``
gathers the films over the default group as CPU tensors (JAX hands host
arrays to ``process_allgather``): the group's backend must move CPU tensors
(gloo, or "cpu:gloo,cuda:nccl"). Every rank gets the films summed in rank
order, so every rank holds the same film.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hijiki_tpu_torch.parallel.multichip import MegaMultiChipRenderer, MultiChipRenderer
from hijiki_tpu_torch.render.reconstruct import normalize_film
from hijiki_tpu_torch.render.renderer import RenderConfig, Renderer
from hijiki_tpu_torch.scene.compile import CompiledScene


def host_sweeps(spp: int, host_id: int, num_hosts: int) -> list:
    """Round-robin sweep assignment: host h gets sweeps h, h + N, ..."""
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} outside [0, {num_hosts})")
    return list(range(host_id, spp, num_hosts))


def merge_films(films):
    """Merge per-host partial films: their sum, in the order given. The
    merged film equals a single-host render of the union of the sweeps up
    to the order of the float sums."""
    out = films[0]
    for f in films[1:]:
        out = out + f
    return out


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


class _HostStrideMixin:
    """A renderer that traces only this host's stride of the sweeps, one
    sweep a chunk, over any base renderer (one device, or a sweep sharded
    over this process's devices). Checkpoints hold this host's film and
    its count of finished sweeps: resume with the same host split."""

    def _init_stride(self, host_id: Optional[int], num_hosts: Optional[int]) -> None:
        import torch.distributed as dist

        up = _group_up()
        self.num_hosts = num_hosts if num_hosts is not None else (
            dist.get_world_size() if up else 1)
        self.host_id = host_id if host_id is not None else (dist.get_rank() if up else 0)
        self.sweep_ids = host_sweeps(self.config.spp, self.host_id, self.num_hosts)
        # the scheduler's draws are stateful (the reference seeds from OS
        # entropy in call order): every host draws the FULL schedule in
        # order and keeps its share, so the union over hosts is the exact
        # single-host sample set
        self._schedules = [self.scheduler.sweep(s) for s in range(self.config.spp)]

    def _todo(self) -> list:
        return self.sweep_ids[self.sweeps_done:]

    def _schedule(self, sweep: int):
        return self._schedules[sweep]

    def _total(self) -> int:
        return len(self.sweep_ids)

    def _chain(self) -> int:
        return 1

    def _resume(self, film, sweeps_done: int) -> None:
        self.film = film.to(self.device)
        self.sweeps_done = sweeps_done

    def render(self, progress=None):
        m = super().render(progress)
        m.update(host_id=self.host_id, num_hosts=self.num_hosts, sweeps=len(self.sweep_ids))
        return m

    def merged_film(self):
        """The full estimate: every host's film summed in rank order. Under
        a process group of more than one rank this gathers the films;
        otherwise it is the local film (simulated hosts merge explicitly
        with ``merge_films``)."""
        import torch.distributed as dist

        film = self.film
        if _group_up() and dist.get_world_size() > 1:
            local = film.cpu()
            parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, local)
            return merge_films(parts).to(film.device)
        return film

    def merged_image(self) -> np.ndarray:
        """Normalized (H, W, 3) RGB of the merged estimate."""
        return normalize_film(self.merged_film()).cpu().numpy()


class MultiHostRenderer(_HostStrideMixin, Renderer):
    """This host's stride of the sweeps on one device."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig,
                 host_id: Optional[int] = None, num_hosts: Optional[int] = None, device="cuda"):
        super().__init__(compiled, config, device=device)
        self._init_stride(host_id, num_hosts)


class MultiHostMultiChipRenderer(_HostStrideMixin, MultiChipRenderer):
    """Blocks shard over this process's devices (every device a process
    sees is local to it: the first ``num_devices``, all for None); sweeps
    stride across processes."""

    def __init__(self, compiled, config, host_id=None, num_hosts=None, num_devices=None,
                 devices=None, device="cuda"):
        super().__init__(compiled, config, num_devices, devices, device)
        self._init_stride(host_id, num_hosts)


class MultiHostMegaRenderer(_HostStrideMixin, MegaMultiChipRenderer):
    """Row bands over this process's devices; sweeps stride across
    processes."""

    def __init__(self, compiled, config, host_id=None, num_hosts=None, num_devices=None,
                 devices=None, device="cuda", interpret=None):
        super().__init__(compiled, config, num_devices, devices, device, interpret)
        self._init_stride(host_id, num_hosts)
