"""Beam search (counterpart of paddle_tpu/nn/decode.py:28-168 and
`gather_tree`, paddle_tpu/ops/extra.py:196-215): the `Decoder` contract,
`BeamSearchDecoder` and `dynamic_decode`.

Beams ride a folded [batch * beam, ...] batch through the user's cell,
batch-major and beam-minor (row b * beam + j is beam j of batch b, as
the reference's `_expand` folds them). A step scores every beam's
extensions (f32 log-softmax of `output_fn(cell output)`; a finished beam
extends only with `end_token` at score 0), keeps the top `beam_size` of
each batch row's [beam * vocab] totals, and gathers the cell states of
the parent beams: every tensor of the state, walked through lists,
tuples, dicts and namedtuples, each rebuilt as its own type (so a
`MultiHeadAttention.Cache` or `StaticCache` stays one). Beam 0 starts at
log-prob 0 and the others at -1e9, so the first step expands one beam
per batch row.

`dynamic_decode` runs `decoder.step` until every beam has finished or
`max_step_num` steps, reading `finished` and the parents on the host
once a step for its early exit and the lengths, as the reference's
contract has it; `finalize` backtracks the beams with `gather_tree`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree"]


def _map(fn, tree):
    """fn on every tensor of a nest of lists, tuples, namedtuples and
    dicts, rebuilt with the same types; anything else is kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _first_tensor(tree):
    out = []
    _map(out.append, tree)
    return out[0]


def gather_tree(ids, parents, name=None):
    """Backtrack beam-search paths: ids and parents [max_time, batch,
    beam] -> the token path ending at each final beam, [max_time, batch,
    beam]."""
    ids, parents = ids.long(), parents.long()
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    out = []
    for t in range(ids.shape[0] - 1, -1, -1):
        out.append(torch.gather(ids[t], 1, beams))
        beams = torch.gather(parents[t], 1, beams)
    return torch.stack(out[::-1])


def beam_totals(log_probs, finished, logits, end_token):
    """One beam-search step's scores: log_probs and finished [batch,
    beam] before the step, logits [batch * beam, V] of the step -> each
    batch row's [beam * V] totals, the beam's log-prob plus the f32
    log-softmax of its extension (a finished beam extends only with
    end_token, at score 0)."""
    nbatch, beam = log_probs.shape
    vocab = logits.shape[-1]
    step_lp = torch.log_softmax(logits.float(), dim=-1).reshape(
        nbatch, beam, vocab)
    eos_only = torch.full((vocab,), -1e9, dtype=torch.float32,
                          device=step_lp.device)
    eos_only[end_token] = 0.0
    step_lp = torch.where(finished[:, :, None], eos_only, step_lp)
    return (log_probs[:, :, None] + step_lp).reshape(nbatch, beam * vocab)


class Decoder:
    """The contract `dynamic_decode` drives:

      initialize(inits) -> (tokens, state)
      step(time, tokens, state) -> (next_tokens, parent_idx, state,
                                    finished)
      finalize(step_tokens, step_parents, final_state) -> outputs
    """

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, tokens, state):
        raise NotImplementedError

    def finalize(self, step_tokens, step_parents, final_state):
        raise NotImplementedError


class BeamSearchDecoder(Decoder):
    """cell(inputs, states) -> (output, new_states); embedding_fn maps
    token ids to the cell's inputs (None: the ids as f32 [N, 1]);
    output_fn maps the cell output to logits (None: the output is)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _expand(self, x):
        return torch.repeat_interleave(x, self.beam_size, dim=0)

    def initialize(self, initial_cell_states):
        states = _map(self._expand, initial_cell_states)
        first = _first_tensor(states)
        nbatch = first.shape[0] // self.beam_size
        dev = first.device
        tokens = torch.full((nbatch, self.beam_size), self.start_token,
                            dtype=torch.long, device=dev)
        log_probs = torch.full((nbatch, self.beam_size), -1e9,
                               dtype=torch.float32, device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((nbatch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return tokens, (states, log_probs, finished)

    def step(self, time, tokens, state):
        cell_states, log_probs, finished = state
        nbatch, beam = tokens.shape
        flat_tok = tokens.reshape(-1)
        inp = (self.embedding_fn(flat_tok) if self.embedding_fn is not None
               else flat_tok[:, None].float())
        out, new_states = self.cell(inp, cell_states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        vocab = logits.shape[-1]
        total = beam_totals(log_probs, finished, logits, self.end_token)
        top_lp, top_idx = torch.topk(total, beam, dim=-1)
        src_beam = torch.div(top_idx, vocab, rounding_mode="floor")
        next_tok = top_idx % vocab
        flat_src = (torch.arange(nbatch, device=tokens.device)[:, None]
                    * beam + src_beam).reshape(-1)
        new_states = _map(lambda a: a[flat_src], new_states)
        new_finished = (torch.gather(finished, 1, src_beam)
                        | (next_tok == self.end_token))
        return (next_tok, src_beam, (new_states, top_lp, new_finished),
                new_finished)

    def finalize(self, step_tokens, step_parents, final_state):
        return gather_tree(torch.stack(step_tokens),
                           torch.stack(step_parents))


def dynamic_decode(decoder, inits=None, max_step_num=64,
                   output_time_major=False, return_length=False, **kwargs):
    """Run `decoder` until every beam finishes or `max_step_num` steps.
    Returns (outputs, final_states[, lengths]): outputs [batch, beam, T]
    token paths ([T, batch, beam] when output_time_major), lengths
    [batch, beam] int64, each beam's step count up to and including its
    end token (T where it never finished)."""
    tokens, state = decoder.initialize(inits)
    step_tokens, step_parents = [], []
    lengths = None
    for t in range(int(max_step_num)):
        next_tok, src_beam, state, finished = decoder.step(t, tokens, state)
        step_tokens.append(next_tok)
        step_parents.append(src_beam)
        # the step's one host read: finished and the parents together
        both = torch.stack((finished.to(src_beam.dtype), src_beam))
        fin_np, src_np = both.cpu().numpy()
        fin_np = fin_np.astype(bool)
        if lengths is None:
            lengths = np.zeros(fin_np.shape, np.int64)
        # beams are reordered each step: the lengths follow their parents
        lengths = np.take_along_axis(lengths, src_np, axis=1)
        lengths = np.where((lengths == 0) & fin_np, t + 1, lengths)
        tokens = next_tok
        if bool(fin_np.all()):
            break
    lengths = np.where(lengths == 0, len(step_tokens), lengths)
    out = decoder.finalize(step_tokens, step_parents, state)
    if not output_time_major:
        out = out.permute(1, 2, 0)
    if return_length:
        return out, state, torch.from_numpy(lengths).to(out.device)
    return out, state
