from repro_torch.serving.coalescer import (  # noqa: F401
    AdmissionRejected,
    BatchCoalescer,
    CoalescerStats,
    DeadlineExceeded,
    ServiceClosed,
)
from repro_torch.serving.service import CacheService, ServiceStats  # noqa: F401
