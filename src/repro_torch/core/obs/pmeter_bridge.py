"""Bridge seed-era Pmeter telemetry into the metrics registry.

One adapter, no schema change: a :class:`~repro_torch.core.carbon.telemetry.
Pmeter`'s accumulated :class:`PmeterRecord`s fold into the registry as
labelled counters/histograms so the paper-faithful Table-1 records and
the fleet observatory share one exporter path.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.obs.metrics import MetricsRegistry, log_bounds

__all__ = ["observe_pmeter"]

#: power draw spans ~10 W idle laptop .. ~1 kW loaded server
_POWER_BOUNDS = log_bounds(1.0, 1e4, per_decade=4)


def observe_pmeter(pmeter, registry: MetricsRegistry,
                   since: Optional[float] = None) -> int:
    """Fold ``pmeter.records`` (optionally only those with ``t > since``)
    into ``registry``.  Returns the number of records folded.

    Emitted series (all labelled ``node=<node_id>``):

    - ``pmeter_records_total``       counter
    - ``pmeter_power_w``             histogram of per-record host power
    - ``pmeter_tx_bytes_total``      counter (write throughput · assumed 1 s)
    - ``pmeter_rx_bytes_total``      counter (read throughput · assumed 1 s)
    - ``pmeter_emissions_g``         gauge (integrated gCO₂ over records)
    """
    node = pmeter.node_id
    c_records = registry.counter("pmeter_records_total", node=node)
    h_power = registry.histogram("pmeter_power_w", bounds=_POWER_BOUNDS,
                                 node=node)
    c_tx = registry.counter("pmeter_tx_bytes_total", node=node)
    c_rx = registry.counter("pmeter_rx_bytes_total", node=node)
    n = 0
    for rec in pmeter.records:
        if since is not None and rec.t <= since:
            continue
        c_records.inc()
        h_power.observe(pmeter.power_w(rec))
        c_tx.inc(rec.network.write_throughput_bps / 8.0)
        c_rx.inc(rec.network.read_throughput_bps / 8.0)
        n += 1
    registry.gauge("pmeter_emissions_g", node=node).set(pmeter.emissions_g())
    return n
