"""Host-side utilities: device timing, tracing and phase timers, and
the TensorBoard event-file writer."""

from pwstablenet_tpu_torch.utils.profiling import scope, trace, wall_breakdown  # noqa: F401
from pwstablenet_tpu_torch.utils.timing import device_time  # noqa: F401
from pwstablenet_tpu_torch.utils.tb_writer import SummaryWriter  # noqa: F401
