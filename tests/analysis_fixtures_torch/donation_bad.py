"""Bad: a stale alias of a buffer a mutator updates in place (expect RA401 x1)."""
import torch


def scatter(bank, idx, rows):
    bank.buf[idx] = rows  # stores through a subscript of a parameter: a mutator


class Bank:
    def __init__(self):
        self.buf = torch.zeros((4, 2))

    def set_rows(self, idx, rows):
        old = self.buf[:2]  # a view of the buffer, bound before the call
        scatter(self, idx, rows)  # updates self.buf in place
        return rows + old.sum()  # RA401: `old` now reads the new values
