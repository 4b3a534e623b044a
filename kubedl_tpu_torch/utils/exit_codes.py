"""Exit-code retry classification for RestartPolicy.ExitCode (the port's
copy of kubedl_tpu/utils/exit_codes.py: the same codes and classes).

Permanent {1, 2, 126, 127, 128, 139}; retryable {130, 137, 143}
(SIGINT/KILL/TERM: transient infrastructure) and 138 (128 + SIGUSR1,
user-defined retryable). The runtime's own codes:
  EXIT_TPU_PREEMPTED (113): preempted or maintenance -> retryable; the
    trainer exits with it after its SIGTERM checkpoint
  EXIT_XLA_COMPILE_ERROR (114): the program cannot be built -> permanent;
    the port exits with it when a kernel does not build or the training
    state does not fit on the device
"""
from __future__ import annotations

EXIT_TPU_PREEMPTED = 113
EXIT_XLA_COMPILE_ERROR = 114

_PERMANENT = {1, 2, 126, 127, 128, 139, EXIT_XLA_COMPILE_ERROR}
_RETRYABLE = {130, 137, 143, 138, EXIT_TPU_PREEMPTED}


def is_retryable_exit_code(exit_code: int) -> bool:
    if exit_code in _PERMANENT:
        return False
    if exit_code in _RETRYABLE:
        return True
    # no guarantee for other codes: treated as permanent
    return False
