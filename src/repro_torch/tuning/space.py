"""The tunable design space on Hopper: one frozen ``TunedConfig`` per
candidate.

The reference also sweeps its Pallas block sizes; the port's kernel tiles
are compiled constants and its decode split count follows the live shape
(``split_plan``), so the knobs here are the serving geometry alone:

  page_size               KV pool page length (paged serving)
  n_slots                 decode slots per device
  prefill_chunk           async-loop prefill chunk

``enumerate_candidates`` yields every combination that passes the
registry's rules (``repro_torch.kernels.registry``); resource fits are the
cost model's job.
"""
from __future__ import annotations

import itertools
from dataclasses import asdict, dataclass, replace
from typing import Iterator, Optional

from repro_torch.kernels import registry as kreg


@dataclass(frozen=True)
class TunedConfig:
    page_size: int = kreg.PAGE_SIZE_DEFAULT
    n_slots: int = kreg.SLOTS_DEFAULT
    prefill_chunk: int = kreg.PREFILL_CHUNK_DEFAULT

    def geometry_key(self) -> str:
        """Compact stable string — becomes part of the ProgramCache key and
        the program descriptor, so tuned/default programs never collide."""
        return f"ps{self.page_size}.s{self.n_slots}.pc{self.prefill_chunk}"

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        return cls(**{k: int(v) for k, v in d.items()
                      if k in cls.__dataclass_fields__})

    def replace(self, **kw) -> "TunedConfig":
        return replace(self, **kw)


DEFAULT = TunedConfig()


def legal_reason(cand: TunedConfig, *, max_len: int, head_dim: int,
                 paged: bool) -> Optional[str]:
    """Divisibility and range legality (mirrors the engine's and the
    kernels' own checks). Returns None when legal, else the first violated
    rule."""
    r = kreg.check_head_dim(head_dim)
    if r is None and paged:
        r = kreg.check_page_size(max_len, cand.page_size)
    if r is None:
        r = kreg.check_slots(max_len, cand.n_slots)
    if r is None:
        r = kreg.check_prefill_chunk(cand.prefill_chunk)
    return r


def enumerate_candidates(*, max_len: int, head_dim: int,
                         paged: bool) -> Iterator[TunedConfig]:
    """Every legal combination: slots x prefill chunks, and page sizes on a
    paged pool (a dense engine keeps the default page size, unused)."""
    page_sizes = kreg.PAGE_SIZE_CHOICES if paged \
        else (kreg.PAGE_SIZE_DEFAULT,)
    for ps, ns, pc in itertools.product(page_sizes, kreg.SLOTS_CHOICES,
                                        kreg.PREFILL_CHUNK_CHOICES):
        cand = TunedConfig(page_size=ps, n_slots=ns, prefill_chunk=pc)
        if legal_reason(cand, max_len=max_len, head_dim=head_dim,
                        paged=paged) is None:
            yield cand
