"""Sample and message stream recording for MCMC runs.

Reproduces the reference's output contract
(``include/ssme/ada_pmmh_mvn.h:272-322``):

- samples file: one CSV row of *constrained* parameters per recorded
  iteration (``record_params``, ``:273-291``);
- messages file: header
  ``iter number, accept rate, old_ll, new_ll, old_lprior, new_lprior,
  accept prob, outcome`` then one row per iteration (``:306-322``);
- ``print_every_k`` decimation (``:275, 297``) and optional console
  mirroring (``:299-300, 316-320``);
- timestamped file names ``base_YYYY-MM-DD.HH-MM-SS``
  (``gen_string_with_time``, ``:374-383``).

Writers use the native background-thread stream when available so the
device never waits on disk.  Numpy-only copy of ``ssme_tpu/io/recording.py``
for the port; results reach it as numpy arrays.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np

from ssme_tpu_torch.native import StreamWriter


def timestamped_path(base_name: str, when: Optional[datetime.datetime] = None
                     ) -> str:
    """``base_YYYY-MM-DD.HH-MM-SS`` (``ada_pmmh_mvn.h:374-383``)."""
    when = when or datetime.datetime.now()
    return f"{base_name}_{when.strftime('%Y-%m-%d.%H-%M-%S')}"


class SampleWriter:
    """Streams constrained parameter samples as CSV rows."""

    def __init__(self, base_name: str, print_every_k: int = 1,
                 timestamp: bool = True):
        path = timestamped_path(base_name) if timestamp else base_name
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.print_every_k = print_every_k
        self._w = StreamWriter(path)

    def record(self, iteration: int, params) -> None:
        if iteration % self.print_every_k != 0:
            return
        row = np.asarray(params).ravel()
        self._w.write(",".join(repr(float(v)) for v in row) + "\n")

    def record_result(self, result, chain: int = 0, start_iter: int = 0
                      ) -> None:
        """Record every recorded iteration of a PMMHResult for one chain."""
        samples = np.asarray(result.samples)
        for i in range(samples.shape[0]):
            self.record(start_iter + i, samples[i, chain])

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


MESSAGE_HEADER = ("iter number, accept rate, old_ll, new_ll, old_lprior, "
                  "new_lprior, accept prob, outcome\n")


class MessageWriter:
    """Streams per-iteration diagnostics in the reference's format."""

    def __init__(self, base_name: str, print_every_k: int = 1,
                 print_to_console: bool = False, timestamp: bool = True):
        path = timestamped_path(base_name) if timestamp else base_name
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.print_every_k = print_every_k
        self.print_to_console = print_to_console
        self._w = StreamWriter(path)
        self._wrote_header = False

    def _emit(self, line: str) -> None:
        self._w.write(line)
        if self.print_to_console:
            print(line, end="")

    def record(self, iteration: int, accept_rate, old_ll, new_ll,
               old_lprior, new_lprior, log_accept_prob, accepted) -> None:
        if not self._wrote_header:
            self._emit(MESSAGE_HEADER)  # ada_pmmh_mvn.h:308-311
            self._wrote_header = True
        # ada_pmmh_mvn.h:313-315: iter is recorded 1-based
        line = (f"{iteration + 1}, {float(accept_rate)}, {float(old_ll)}, "
                f"{float(new_ll)}, {float(old_lprior)}, {float(new_lprior)}, "
                f"{float(log_accept_prob)}, {int(bool(accepted))}\n")
        self._emit(line)

    def record_result(self, result, chain: int = 0, start_iter: int = 0
                      ) -> None:
        n = np.asarray(result.samples).shape[0]
        for i in range(n):
            it = start_iter + i
            if it % self.print_every_k != 0:
                continue
            self.record(
                it,
                np.asarray(result.accept_rate)[i, chain],
                np.asarray(result.log_likes)[i, chain],
                np.asarray(result.new_log_likes)[i, chain],
                np.asarray(result.log_priors)[i, chain],
                np.asarray(result.new_log_priors)[i, chain],
                np.asarray(result.log_accept_probs)[i, chain],
                np.asarray(result.accepted)[i, chain],
            )

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["SampleWriter", "MessageWriter", "MESSAGE_HEADER",
           "timestamped_path"]
