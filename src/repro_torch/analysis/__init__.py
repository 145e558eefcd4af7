"""repro_torch.analysis — static analysis of the port's device hazards.

The port's performance story rests on invariants no generic linter knows
about: the read path must stay one stream of device work with zero host
hops, a device region must hold no host sync, no implicit
``bool(tensor)`` and no host->device upload (each stalls the host, and
none can be captured in a CUDA graph), its compile caches must not miss
per request, the serving layer's hand-maintained locks must cover the
state they claim to, a buffer updated in place must not be read through
a stale alias, and the int32 logical clocks must rebase before they
saturate. Each checker encodes one of those invariants over the stdlib
``ast`` (no third-party dependencies), seeded with an interprocedural
call graph so a sync three calls below a device region is still caught.
Device regions are marked defs (``# repro: device-region static[...]``),
autograd ``Function``s, ``nn.Module.forward`` and captured callables
(``repro_torch.analysis.project``).

Run it as ``python -m repro_torch.analysis [--baseline FILE]``. Findings
print as ``path:line: CODE message``. Grandfathered findings live in a
baseline (keyed without line numbers, so they survive drift); code
suppresses an intentional finding inline with ``# repro: noqa[CODE]`` plus
a short justification.

Codes:
  RA101  host sync inside a device region (.item(), .tolist(), .cpu(),
         .numpy(), .to("cpu"), synchronize, fetch, np.asarray or
         int/float/bool of a device value, nonzero / one-argument where /
         masked_select / unique / bincount / repeat_interleave without
         output_size, a boolean mask index)
  RA201  compile-cache miss at an lru_cache factory (per-request size or
         unhashable literal passed, cache built in a loop)
  RA202  Python branch on a device tensor (implicit bool(tensor))
  RA203  host->device upload inside a device region (CUDA-graph capture
         break: torch.tensor/as_tensor(device=...), to_device,
         .to(device)/.cuda() of a host value, a host index)
  RA301  guarded attribute accessed without its lock
  RA401  stale alias of a buffer that a mutator updated in place
  RA501  int32 monotonic counter incremented without a rebase guard
  RA502  float32 narrowing of an absolute timestamp
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

from repro_torch.analysis.core import Baseline, Finding, SourceModule, collect_modules

CHECKERS: Dict[str, Callable] = {}


def register(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        CHECKERS[name] = fn
        return fn

    return deco


@dataclass
class Scan:
    """One run of every checker: the findings left after inline
    suppressions, the suppressed ones, and the index they came from."""

    findings: List[Finding]
    suppressed: List[Finding]
    project: object  # repro_torch.analysis.project.ProjectIndex


def scan(paths: List[str], root: str) -> Scan:
    """Parse ``paths`` (files or directories) and run every registered
    checker."""
    from repro_torch.analysis.project import ProjectIndex
    import repro_torch.analysis.checkers  # noqa: F401 — registers the checkers

    modules = collect_modules(paths, root)
    project = ProjectIndex(modules)
    findings: List[Finding] = []
    for checker in CHECKERS.values():
        findings.extend(checker(project))
    by_rel = {m.rel: m for m in modules}
    order = lambda f: (f.path, f.line, f.code, f.message)  # noqa: E731
    kept, suppressed = [], []
    for f in set(findings):
        (suppressed if by_rel[f.path].suppressed(f.line, f.code) else kept).append(f)
    return Scan(sorted(kept, key=order), sorted(suppressed, key=order), project)


def run_checks(paths: List[str], root: str) -> List[Finding]:
    """Parse ``paths`` (files or directories), run every registered checker,
    and return suppression-filtered findings sorted by location."""
    return scan(paths, root).findings


__all__ = ["Baseline", "Finding", "SourceModule", "CHECKERS", "Scan", "register",
           "run_checks", "scan"]
