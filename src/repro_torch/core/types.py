"""Core dataclasses of the LDA stack (counterpart of ``repro.core.types``).

Notation follows the paper (Table 1): D documents per mini-batch, W
vocabulary size, K topics, L max distinct words per document.  A
mini-batch is padded-CSR: document d owns L word slots, slot l holds a
vocabulary row ``word_ids[d, l]`` and a count ``counts[d, l]``; padding
slots carry row 0 and count 0.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels.token_order import (sweep_order, token_chunks,
                                             token_runs)


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Static configuration of an LDA/POBP run; the same fields and defaults
    as the reference, so checkpoint run signatures parse unchanged.

    ``impl`` is kept for that reason only: the port picks its code path by
    the device of the tensors (a CUDA tensor runs the kernel, a CPU tensor
    the plain version), never by this field.
    """

    vocab_size: int
    num_topics: int
    alpha: float = 0.1
    beta: float = 0.01
    lambda_w: float = 0.1
    lambda_k_abs: int = 50
    inner_iters: int = 10
    residual_tol: float = 0.1
    lr_schedule: str = "paper"
    lr_tau0: float = 1.0
    lr_kappa: float = 0.9
    decay_tau0: float = 1.0
    decay_kappa: float = 0.0
    sync_dtype: str = "float32"
    impl: str = "jnp"
    sweep_policy: str = "auto"
    vmem_budget_bytes: Optional[int] = None
    phi_acc_dtype: str = "float32"
    onehot_crossover: int = 8_000_000
    init_pad_len: Optional[int] = None

    @property
    def num_power_words(self) -> int:
        return max(1, int(round(self.lambda_w * self.vocab_size)))

    @property
    def num_power_topics(self) -> int:
        return max(1, min(self.lambda_k_abs, self.num_topics))

    def delta_weight(self, m: int) -> float:
        """Weight on the current mini-batch's Delta-phi (Eq. 11): 1.0 under
        the 'paper' schedule, (tau0 + m)^-kappa under 'power'."""
        if self.lr_schedule == "paper":
            return 1.0
        return float((self.lr_tau0 + m) ** (-self.lr_kappa))


@dataclasses.dataclass
class MiniBatch:
    """Padded-CSR mini-batch: word_ids int32 [D, L], counts float32 [D, L]."""

    word_ids: torch.Tensor
    counts: torch.Tensor

    @property
    def num_docs(self) -> int:
        return self.word_ids.shape[0]

    @property
    def max_len(self) -> int:
        return self.word_ids.shape[1]

    def num_tokens(self) -> torch.Tensor:
        return torch.sum(self.counts)

    def token_layout(self) -> "TokenLayout":
        """Flatten to the token-major [T] layout (T = D*L, row-major, so
        each document's tokens are contiguous)."""
        D, L = self.word_ids.shape
        return TokenLayout(
            word_ids=self.word_ids.reshape(-1),
            counts=self.counts.reshape(-1, 1),
            doc_ids=torch.arange(D, dtype=torch.int32,
                                 device=self.word_ids.device
                                 ).repeat_interleave(L),
            num_docs=D, max_len=L)


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """Token-major view of a padded-CSR mini-batch.

    word_ids: int32 [T]    vocabulary row per token slot (0 for padding)
    counts:   float32 [T, 1] count per token slot        (0 for padding)
    doc_ids:  int32 [T]    owning document, non-decreasing
    """

    word_ids: torch.Tensor
    counts: torch.Tensor
    doc_ids: torch.Tensor
    num_docs: int
    max_len: int

    @property
    def num_slots(self) -> int:
        return self.num_docs * self.max_len

    @functools.cached_property
    def sweep_order(self) -> torch.Tensor:
        """`sweep_order` of the tokens by word, made once per mini-batch (a
        port-only field: the packed kernel's visiting order)."""
        return sweep_order(self.word_ids, self.counts)

    @functools.cached_property
    def _runs(self) -> dict:
        return {}

    def word_runs(self, vocab_size: int):
        """`token_runs` of the tokens by word over ``vocab_size`` words, on
        `sweep_order`, made once per mini-batch: the visiting order of the
        fixed-order sums (the word scatter, the carry sweep's d/r)."""
        W = int(vocab_size)
        if W not in self._runs:
            self._runs[W] = token_runs(self.word_ids, self.counts, W,
                                       self.sweep_order)
        return self._runs[W]

    @functools.cached_property
    def _chunks(self) -> dict:
        return {}

    def word_chunks(self, vocab_size: int) -> torch.Tensor:
        """`token_chunks` of `word_runs` over ``vocab_size`` words, made
        once per mini-batch: the chunks of the carry sweep's d/r fold."""
        W = int(vocab_size)
        if W not in self._chunks:
            self._chunks[W] = token_chunks(self.word_runs(W)[1])
        return self._chunks[W]

    def to_batch_major(self, values_tk: torch.Tensor) -> torch.Tensor:
        """[T, K] token-major tensor back to the [D, L, K] batch view."""
        return values_tk.reshape(self.num_docs, self.max_len, -1)


@dataclasses.dataclass
class LDATrainState:
    """State carried by the streaming POBP step (``core.pobp``) from one
    mini-batch to the next.

    phi_acc[W, K]  accumulated topic-word sufficient statistics (Eq. 11),
                   float32 or bfloat16 (``cfg.phi_acc_dtype``), on the
                   step's device
    m              mini-batches consumed so far (batch m+1 is the next)
    generator      ``torch.Generator`` on phi_acc's device; the step draws
                   each mini-batch's random message init from it (the
                   reference splits a PRNG key instead, so the two packages
                   draw different numbers from one seed)
    """

    phi_acc: torch.Tensor
    m: int
    generator: torch.Generator
