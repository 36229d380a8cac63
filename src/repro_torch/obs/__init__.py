"""Observability layer (DESIGN.md §12): pluggable Tracker backends,
a counters/gauges/histograms metrics registry, and a Chrome-trace
(Perfetto-loadable) exporter over the §8 runtime event stream."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (
    chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.tracker import (
    TRACKER_BACKENDS,
    CompositeTracker,
    CsvTracker,
    JsonlTracker,
    MemoryTracker,
    NullTracker,
    TensorBoardTracker,
    Tracker,
    make_tracker,
    read_jsonl,
)
