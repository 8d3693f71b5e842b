"""Speculative-decoding drafters for the DecodeEngine (counterpart of
``paddle_tpu/serving/spec.py``; Leviathan et al. 2023).

Decode reads every weight for one token a slot. Speculation turns k cheap
guesses plus one ``[1, k + 1]`` verify call into up to k + 1 emitted
tokens. Greedy acceptance is exact: a draft is accepted only when the
verifier's argmax at the position before it IS that draft, and the
verifier's token at the first disagreement is emitted too, so every
emitted token is the one sequential greedy decode picks.

This module owns the guessing side, a ``Drafter`` interface and three
drafters:

* ``PromptLookupDrafter``: n-gram lookup over the request's own history
  (prompt + generated tokens), host code only;
* ``DraftModelDrafter``: a small causal LM (GPT or LLaMA) proposes k
  tokens greedily;
* ``EarlyExitDrafter``: the target model proposes through a strided
  subset of its own blocks (``layer_subset``: blocks 0, interval,
  2 interval, ...), sharing the verifier's weights.

The two model drafters run ONE fixed-shape ``[1, ctx_len]`` program each
(``core/programs.py``: a CUDA graph on the card), the uncached forward
over the last ``ctx_len`` tokens of the history with the ids and the
window's length as staged data, the last valid position picked on the
device; ``compile_count`` is the drafter's own recompile sentinel. The
window slides by one token a draft, k replays a proposal, so the draft
model needs no KV cache and the engine's pager never learns it exists.
The forward runs inside ``flash_at_any_length``: on the card its
attention goes through the flash kernels (GPT's packed pair kernels, or
LLaMA's ``[B, L, H, D]`` kernels) at a window of 64 as well.

Drafts never change a program's shape: they are clipped to the verify
width and ride as ids. Per-request drafter state lives in
``Request.drafter_state``, reset at every (re-)admission.
"""
from __future__ import annotations

import weakref
from functools import partial
from typing import List

import torch

from ..core.programs import (ProgramRegistry, StagedInputs, leaf_addresses,
                             serving_mode)
from ..models.gpt import _lm_head_logits
from ..nn.functional import flash_at_any_length
from .engine import _model_spec

__all__ = ["Drafter", "PromptLookupDrafter", "DraftModelDrafter",
           "EarlyExitDrafter"]


class Drafter:
    """The interface the engine drives. ``propose`` may return fewer than
    k tokens, or none (the engine then verifies the carried token alone);
    it never raises on a well-formed request. ``name`` keys the engine's
    ``stats()["spec"]``; ``max_k`` sizes the verify width."""

    name = "drafter"
    max_k = 4

    def begin_request(self, req) -> None:
        """``req`` went live on a slot (a re-admission after preemption
        too: its token history restarted, so its drafter state does)."""
        req.drafter_state = {}

    def propose(self, req, k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``req.prompt +
        req.tokens``; called once per speculative step per slot."""
        raise NotImplementedError

    def observe(self, req, accepted: int, drafted: int) -> None:
        """Feedback from the verify (an adaptive drafter tunes k here; the
        default keeps counts in the request's drafter state)."""
        st = req.drafter_state if req.drafter_state is not None else {}
        st["drafted"] = st.get("drafted", 0) + int(drafted)
        st["accepted"] = st.get("accepted", 0) + int(accepted)
        req.drafter_state = st


class PromptLookupDrafter(Drafter):
    """Prompt-lookup (n-gram) drafting: find the most recent earlier
    occurrence of the history's trailing n-gram and propose what followed
    it, ``max_n`` down to ``min_n`` (a longer match is more specific, so it
    is tried first). No model and no device work."""

    name = "prompt_lookup"

    def __init__(self, max_n: int = 3, min_n: int = 1, max_k: int = 8):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.max_n = int(max_n)
        self.min_n = int(min_n)
        self.max_k = int(max_k)

    def propose(self, req, k: int) -> List[int]:
        hist = list(req.prompt) + list(req.tokens)
        n_hist = len(hist)
        k = min(int(k), self.max_k)
        if k < 1:
            return []
        for n in range(self.max_n, self.min_n - 1, -1):
            if n_hist < n + 1:
                continue
            pat = hist[n_hist - n:]
            # the newest earlier occurrence wins: recent context predicts
            # the continuation better than a stale one
            for i in range(n_hist - n - 1, -1, -1):
                if hist[i:i + n] == pat:
                    cont = hist[i + n:i + n + k]
                    if cont:
                        return cont
                    break          # a match flush at the end: try shorter n
        return []


class _ModelDrafter(Drafter):
    """A drafter that runs a causal LM: one ``[1, ctx_len]`` program (the
    greedy token after the window's last valid position), replayed k times
    over a sliding window a proposal. Once the history outgrows
    ``ctx_len`` the window's positions drift from the absolute ones, which
    is harmless: drafts are guesses, and only the verifier's positions
    must be exact."""

    def __init__(self, model, ctx_len: int = 64, max_k: int = 4):
        if ctx_len < 2:
            raise ValueError(f"ctx_len must be >= 2, got {ctx_len}")
        self.model = model
        self.ctx_len = int(ctx_len)
        self.max_k = int(max_k)
        self._programs = None
        # program calls (replays on the card, after the first): what the
        # launches of the program's kernels are counted from
        self.calls = 0

    @property
    def compile_count(self) -> int:
        """Programs this drafter built: 1 once warm, flat after."""
        return 0 if self._programs is None else self._programs.count

    def _backbone(self, spec, ids):
        """Hidden states of the drafting forward over ``ids``."""
        raise NotImplementedError

    def _program(self):
        model = self.model
        if self._programs is None:
            self.ctx_len = min(self.ctx_len,
                               int(model.config.max_position_embeddings))
            self._programs = ProgramRegistry(model.head_weight.device,
                                             partial(serving_mode, model))
        self._programs.validate(leaf_addresses(model))
        return self._programs.get(("draft", self.ctx_len), self._build)

    def _build(self):
        model = self.model
        spec = _model_spec(model)
        inputs = StagedInputs(model.head_weight.device,
                              ids=(1, self.ctx_len), length=())
        out = torch.zeros(1, dtype=torch.int64,
                          device=model.head_weight.device)
        t = inputs.dev
        # the program holds its drafter weakly (see engine._build_slot_call)
        drafter = weakref.proxy(self)

        def fn():
            with flash_at_any_length():
                hidden = drafter._backbone(spec, t["ids"])
            last = (t["length"] - 1).reshape(1)
            logits = _lm_head_logits(hidden.index_select(1, last)[:, 0],
                                     model.head_weight)
            out.copy_(torch.argmax(logits, dim=-1))
        return fn, (inputs, out)

    def propose(self, req, k: int) -> List[int]:
        prog = self._program()
        k = min(int(k), self.max_k)
        if k < 1:
            return []
        inputs, out = prog.state
        ids, length = inputs.host["ids"], inputs.host["length"]
        window = (list(req.prompt) + list(req.tokens))[-self.ctx_len:]
        drafts: List[int] = []
        for _ in range(k):
            n = len(window)
            ids.fill(0)
            ids[0, :n] = window
            length[...] = n
            inputs.upload()
            prog()
            self.calls += 1
            tok = int(out.item())
            drafts.append(tok)
            window.append(tok)
            if len(window) > self.ctx_len:
                window.pop(0)
        return drafts


class DraftModelDrafter(_ModelDrafter):
    """Draft-model speculation: a SMALL causal LM (GPT or LLaMA, tied or
    untied head) proposes, the engine's model verifies. Its vocabulary
    should cover the target's: a draft out of range is never accepted,
    only wasted."""

    name = "draft_model"

    def __init__(self, model, ctx_len: int = 64, max_k: int = 4):
        super().__init__(model, ctx_len, max_k)

    def _backbone(self, spec, ids):
        return spec.backbone(ids)


class EarlyExitDrafter(_ModelDrafter):
    """Self-speculative drafting: the TARGET model proposes through blocks
    0, interval, 2 interval, ... of its own stack (``layer_subset``), then
    verifies at full depth. The weights are the verifier's: nothing extra
    to train, quantize or hold."""

    name = "early_exit"

    def __init__(self, model, interval: int = 2, ctx_len: int = 64,
                 max_k: int = 4):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        super().__init__(model, ctx_len, max_k)
        self.interval = int(interval)

    def _backbone(self, spec, ids):
        subset = frozenset(range(0, spec.num_layers, self.interval))
        return spec.backbone(ids, layer_subset=subset)
