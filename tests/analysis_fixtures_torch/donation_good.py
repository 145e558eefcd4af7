"""Good: a copy taken before the in-place update, or the buffer read afresh."""
import torch


def scatter(bank, idx, rows):
    bank.buf[idx] = rows


def touch(counts, idx):
    counts.index_put_((idx,), torch.ones_like(idx), accumulate=True)


class Bank:
    def __init__(self):
        self.buf = torch.zeros((4, 2))
        self.counts = torch.zeros(4, dtype=torch.int64)

    def set_rows(self, idx, rows):
        old = self.buf[:2].clone()  # .clone() breaks the alias
        scatter(self, idx, rows)
        return rows + old.sum() + self.buf.sum()  # the buffer itself: the new values

    def bump(self, idx):
        before = self.counts.clone()
        touch(self.counts, idx)
        return self.counts - before
