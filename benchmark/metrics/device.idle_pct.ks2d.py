"""``device.idle_pct`` in the KS cell, whose end-to-end time is read from
the device and not from the host's clock: the same reading under a name
of its own, since a per-layer metric moves one end-to-end metric."""

from benchmark.harness import load_metric

read = load_metric("device.idle_pct").read
