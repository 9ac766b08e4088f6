"""The calibration fleet (counterpart of ``sagecal_tpu/fleet``): many
serve workers draining one shared request queue.

- :mod:`~sagecal_tpu_torch.fleet.queue` — the shared work queue: one item
  file per request, lease epochs published atomically, expiry and
  stealing, done and failure markers;
- :mod:`~sagecal_tpu_torch.fleet.admission` — admission control on the
  ``obs/slo.py`` burn rates: shed or degrade on overload;
- :mod:`~sagecal_tpu_torch.fleet.worker` — the claim-admit-solve-complete
  loop over the calibration service;
- :mod:`~sagecal_tpu_torch.fleet.coordinator` — seeds the queue, spawns
  and watches the workers, reports the merged fleet view;
- :mod:`~sagecal_tpu_torch.fleet.stream` — the stream calibrator:
  sliding-window solves with a warm-start chain and owner-lease
  checkpoints;
- :mod:`~sagecal_tpu_torch.fleet.loadgen` — the seeded open-loop load
  generator against a live fleet.
"""

from sagecal_tpu_torch.fleet.queue import (  # noqa: F401
    LeaseLost, LeaseQueue, WorkItem,
)
