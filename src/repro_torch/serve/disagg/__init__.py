"""Disaggregated prefill/decode serving.

Prefill is compute-bound, decode weight-bandwidth-bound: the split NeCTAr
resolves with near-core and near-memory accelerators. The
DisaggCoordinator runs each phase on its own Engine and moves finished
prefills over as a paged-KV block copy (PagedKVCache.export_blocks /
import_blocks and ``ModelRunner.import_blocks_from``), so decode ticks
never share a batch with prefill chunks.
"""

from repro_torch.serve.disagg.coordinator import (DisaggCoordinator,
                                                  MergedCollector)

__all__ = ["DisaggCoordinator", "MergedCollector"]
