"""nomad_tpu_torch.resilience — the eval-lifecycle deadline exceptions
(:mod:`errors`) the server worker raises and catches. The breakers and the
watchdog are not ported yet (ROADMAP A14): a kernel wrapper raises on a
failed launch and nothing falls back to a plain version on a CUDA tensor.
"""

from .errors import EvalDeadlineExceeded, KernelDeadlineExceeded

__all__ = ["EvalDeadlineExceeded", "KernelDeadlineExceeded"]
