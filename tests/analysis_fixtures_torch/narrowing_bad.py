"""Bad: torch's narrowing forms of absolute timestamps (expect RA502 x4)."""
import time

import torch


def stamps(created_at, expires_at, now_s):
    a = torch.tensor(time.time(), dtype=torch.float32)  # RA502
    b = torch.full((4,), created_at, dtype=torch.float32)  # RA502
    c = expires_at.to(torch.float32)  # RA502
    d = now_s.float()  # RA502
    return a, b, c, d
