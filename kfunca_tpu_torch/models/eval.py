"""Evaluation: corpus perplexity and token accuracy.

Counterpart of kfunca_tpu/models/eval.py.  Built on the chunked-vocab loss,
so the NLL of a large-vocab checkpoint never materializes (B, S, V) logits,
and run under torch.no_grad().
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..runtime.backend import resolve_device
from .train import check_params_device
from .transformer import TransformerConfig, forward, loss_fn_chunked


def _batch_stats(params, tokens, targets, cfg: TransformerConfig,
                 vocab_chunk: int, ignore_index: int | None):
    """(sum_nll, n_tokens, n_correct) for one batch: summed, not averaged,
    so batches of different valid-token counts combine exactly."""
    if ignore_index is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    else:
        mask = (targets != ignore_index).float()
    n = mask.sum()
    mean_nll = loss_fn_chunked(params, tokens, targets, cfg, vocab_chunk,
                               ignore_index=ignore_index)
    # greedy token accuracy (argmax over full logits, one batch at a time)
    pred = forward(params, tokens, cfg).argmax(dim=-1)
    correct = ((pred == targets).float() * mask).sum()
    return mean_nll * n, n, correct


@torch.no_grad()
def evaluate(params, cfg: TransformerConfig, batches, *,
             vocab_chunk: int = 4096, ignore_index: int | None = None,
             max_batches: int | None = None, device=None) -> dict:
    """Aggregate metrics over an iterable of (tokens, targets) batches
    (numpy arrays or tensors, e.g. from models.data.TokenDataset), on
    `device` (default: the CUDA device), where params must already be.

    Returns {"nll": token-mean negative log likelihood,
             "perplexity": exp(nll),
             "token_accuracy": greedy next-token accuracy,
             "tokens": number of (unmasked) tokens scored}."""
    dev = check_params_device(params, resolve_device(device))
    tot_nll = tot_n = tot_correct = 0.0
    for i, (tokens, targets) in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        s_nll, n, c = _batch_stats(
            params, torch.as_tensor(tokens).to(dev).long(),
            torch.as_tensor(targets).to(dev).long(), cfg, vocab_chunk,
            ignore_index)
        tot_nll += float(s_nll)
        tot_n += float(n)
        tot_correct += float(c)
    if tot_n == 0:
        raise ValueError("evaluate: no tokens scored")
    nll = tot_nll / tot_n
    return {
        "nll": nll,
        "perplexity": math.exp(min(nll, 700.0)),
        "token_accuracy": tot_correct / tot_n,
        "tokens": int(tot_n),
    }


def perplexity(params, cfg: TransformerConfig, token_array, *,
               batch_size: int = 8, seq_len: int | None = None,
               vocab_chunk: int = 4096, device=None) -> float:
    """Perplexity of a flat token array under the model: the corpus is cut
    into contiguous non-overlapping windows (a partial tail window is
    dropped)."""
    tokens = np.asarray(token_array)
    seq_len = seq_len or cfg.max_seq_len
    win = seq_len + 1
    n_win = tokens.shape[0] // win
    if n_win == 0:
        raise ValueError(f"corpus shorter than one {win}-token window")
    w = tokens[: n_win * win].reshape(n_win, win).astype(np.int32)

    def batches():
        for i in range(0, n_win - n_win % batch_size, batch_size):
            b = w[i : i + batch_size]
            yield b[:, :-1], b[:, 1:]
        # remainder as a final smaller batch
        r = n_win % batch_size
        if n_win < batch_size or r:
            b = w[n_win - r :] if n_win >= batch_size else w
            if b.shape[0]:
                yield b[:, :-1], b[:, 1:]

    return evaluate(params, cfg, batches(), vocab_chunk=vocab_chunk,
                    device=device)["perplexity"]
