"""Batched autoregressive sampling (counterpart of
`unpaired_image_captioning_tpu/ops/sampling.py`).

Greedy (argmax) or multinomial (Gumbel-max with a temperature) decoding
with the reference's semantics: token 0 is BOS and EOS; once a sequence
emits 0 it stays 0; the recorded logprob is that of the sampled token, 0
once the sequence has finished. The loop stops once every row has finished,
reading one scalar a step, where the JAX package's `while_loop` tests
`any(unfinished)`.

The model is abstracted as a step function:
    step_fn(state, it) -> (logprobs [B, V+1], new_state)
where `it` is the previous token ids [B] (0 at t=0 = BOS feed).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def gumbel_argmax(logprobs: torch.Tensor, generator: torch.Generator,
                  temperature: float = 1.0) -> torch.Tensor:
    """One draw from softmax(logprobs / temperature) per row, by Gumbel-max:
    uniform noise on [1e-20, 1) from `generator`, as the JAX package draws
    it with `jax.random.uniform(minval=1e-20, maxval=1.0)`."""
    u = torch.rand(logprobs.shape, generator=generator,
                   device=logprobs.device) * (1.0 - 1e-20) + 1e-20
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logprobs / temperature + gumbel, dim=-1)


def sample(step_fn: Callable, init_state, batch_size: int, seq_length: int,
           *, device, greedy: bool = True, temperature: float = 1.0,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (seq [B, T] int64, logprobs [B, T] f32).

    greedy=True  -> argmax decode (reference sample_max=1); the first
                    maximal index, as `jnp.argmax`.
    greedy=False -> multinomial with temperature (reference sample_max=0),
                    drawn from `generator` (required).
    """
    if not greedy and generator is None:
        raise ValueError("multinomial sampling draws from a generator")
    it = torch.zeros((batch_size,), dtype=torch.int64, device=device)
    unfinished = torch.ones((batch_size,), dtype=torch.bool, device=device)
    seq = torch.zeros((batch_size, seq_length), dtype=torch.int64,
                      device=device)
    logps = torch.zeros((batch_size, seq_length), dtype=torch.float32,
                        device=device)
    state = init_state
    for t in range(seq_length):
        logprobs, state = step_fn(state, it)
        logprobs = logprobs.float()
        if greedy:
            nxt = torch.argmax(logprobs, dim=-1)
        else:
            nxt = gumbel_argmax(logprobs, generator, temperature)
        tok_logprob = logprobs.gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(unfinished, nxt, torch.zeros_like(nxt))
        seq[:, t] = nxt
        logps[:, t] = torch.where(unfinished, tok_logprob,
                                  torch.zeros_like(tok_logprob))
        unfinished = unfinished & (nxt > 0)
        it = nxt
        # the reference's `if unfinished.sum() == 0: break` (one read a step)
        if not bool(unfinished.any()):
            break
    return seq, logps
