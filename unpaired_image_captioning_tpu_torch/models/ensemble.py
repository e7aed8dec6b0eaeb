"""Model ensembles: probabilities averaged after the softmax, then logged
again (counterpart of `unpaired_image_captioning_tpu/models/ensemble.py`).

Each member keeps its own ctx and state side by side (tuples); each step's
distributions are averaged in probability space, and the shared beam
search runs on the mixed distribution, each member's ctx expanded to the
beams by its own `beam_ctx_no_expand` (a member without a ctx, fc, keeps
None).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .base import CaptionDecoder, Features


class AttEnsemble:
    def __init__(self, models: Sequence[CaptionDecoder]):
        self.models = tuple(models)
        assert len(self.models) >= 1
        assert len({m.seq_length for m in self.models}) == 1, (
            "ensemble members must share seq_length")
        assert len({m.vocab_size for m in self.models}) == 1, (
            "ensemble members must share vocab")

    @property
    def seq_length(self) -> int:
        return self.models[0].seq_length

    @property
    def vocab_size(self) -> int:
        return self.models[0].vocab_size

    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator=None):
        ctxs, states = [], []
        for m in self.models:
            ctx, st = m.make_decoder(feats, training=training,
                                     generator=generator)
            ctxs.append(ctx)
            states.append(st)
        return tuple(ctxs), tuple(states)

    def step(self, ctxs, states, it, *, training: bool = False,
             generator=None):
        probs = None
        new_states = []
        for m, c, s in zip(self.models, ctxs, states):
            lp, ns = m.step(c, s, it, training=training, generator=generator)
            pr = torch.exp(lp)
            probs = pr if probs is None else probs + pr
            new_states.append(ns)
        probs = probs / len(self.models)
        return torch.log(torch.clamp(probs, min=1e-20)), tuple(new_states)

    @torch.no_grad()
    def sample(self, feats: Features, *, greedy: bool = True,
               temperature: float = 1.0, generator=None):
        from ..ops.sampling import sample as sample_tokens

        ctxs, states = self.make_decoder(feats)
        ctxs = tuple(m.decode_ctx(c) for m, c in zip(self.models, ctxs))

        def step_fn(state, it):
            return self.step(ctxs, state, it)

        return sample_tokens(step_fn, states, feats.fc_feats.shape[0],
                             self.seq_length, device=feats.fc_feats.device,
                             greedy=greedy, temperature=temperature,
                             generator=generator)

    @torch.no_grad()
    def sample_beam(self, feats: Features, *, beam_size: int, **beam_opts):
        from ..ops.beam_search import beam_search

        ctxs, states = self.make_decoder(feats)
        ctxs = tuple(m.decode_ctx(c) for m, c in zip(self.models, ctxs))

        def step_fn(c, state, it):
            return self.step(c, state, it)

        # per-member unexpanded beam memories: each member's attention
        # handles the [B*K] query against its [B] memory
        no_expand = tuple(m.beam_ctx_no_expand for m in self.models)
        return beam_search(step_fn, ctxs, states, beam_size=beam_size,
                           seq_length=self.seq_length,
                           ctx_no_expand=no_expand, **beam_opts)
