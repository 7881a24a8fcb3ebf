"""Ahead-of-time export of the inference chunk step: ``torch.export`` of
``Stabilizer._chunk`` at a fixed frame geometry, saved as a ``.pt2``
archive that reloads without the port's model code.

The generator's weights stay ARGUMENTS of the exported program, not
constants baked into it: one artifact serves any compatible
``state_dict`` (a ``Stabilizer``'s, or one from ``train.checkpoint``),
and the artifact stays small.

The two warps are the operators ``pwst::grid_sample_f32`` and
``pwst::grid_sample_packed_u8`` (``kernels.grid_sample``), one call node
each in the graph: the device is chosen when the program runs, so a
program traced on the CPU launches the CUDA kernels when it runs on the
card.  ``ExportedStabilizerStep.load`` imports that module first, so the
operators are registered before the archive is read.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from pwstablenet_tpu_torch.pipeline import Stabilizer


def _by_name(state_dict: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """A plain dict of the weights on ``device``, in name order: the
    exported program takes exactly this structure."""
    return {k: state_dict[k].to(device) for k in sorted(state_dict)}


class _ChunkStep(torch.nn.Module):
    """``(state_dict, frames) -> (stabilized, warp_fields)`` of one
    ``Stabilizer`` (which is held outside the module tree, so its
    weights do not become the program's constants)."""

    def __init__(self, stab: Stabilizer):
        super().__init__()
        self._chunk = stab._chunk

    def forward(self, state_dict: Dict[str, torch.Tensor], frames: torch.Tensor):
        return self._chunk(frames, state_dict)


def export_chunk_step(
    stab: Stabilizer,
    frame_hw: Tuple[int, int],
    batch_windows: Optional[int] = None,
    dtype: torch.dtype = torch.uint8,
) -> torch.export.ExportedProgram:
    """Export the chunk step for a fixed frame geometry, traced on
    ``stab``'s device.

    The exported callable has signature ``(state_dict, frames) ->
    (stabilized, warp_fields)`` with ``frames`` of shape
    ``(batch_windows + T - 1, H, W, 3)`` in ``dtype`` (uint8 transport by
    default, as the decoder gives it)."""
    h, w = frame_hw
    n = batch_windows or stab.pipeline_cfg.batch_windows
    T = stab.model_cfg.temporal_window
    frames = torch.zeros((n + T - 1, h, w, 3), dtype=dtype, device=stab.device)
    state_dict = _by_name(stab.model.state_dict(), stab.device)
    with torch.no_grad():
        program = torch.export.export(_ChunkStep(stab), (state_dict, frames))
    # the example inputs (the weights and a chunk) would be saved with it
    program.example_inputs = None
    return program


def save_chunk_step(path: str, *args, **kwargs) -> str:
    """``export_chunk_step(*args, **kwargs)`` saved to ``path`` (.pt2)."""
    torch.export.save(export_chunk_step(*args, **kwargs), path)
    return path


class ExportedStabilizerStep:
    """A loaded chunk step: ``step(state_dict, frames)``.

    Runs on the device of ``frames``: the program is moved there (once a
    device) and the weights follow the frames."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._modules: Dict[torch.device, torch.nn.Module] = {}

    @classmethod
    def load(cls, path: str) -> "ExportedStabilizerStep":
        import pwstablenet_tpu_torch.kernels.grid_sample  # noqa: F401  registers pwst::

        return cls(torch.export.load(path))

    def _module(self, device: torch.device) -> torch.nn.Module:
        if device not in self._modules:
            from torch.export.passes import move_to_device_pass

            self._modules[device] = move_to_device_pass(self.program, device).module()
        return self._modules[device]

    def __call__(self, state_dict: Dict[str, torch.Tensor], frames: torch.Tensor):
        with torch.no_grad():
            return self._module(frames.device)(_by_name(state_dict, frames.device), frames)
