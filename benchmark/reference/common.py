"""Parts the reference models share: the log-mel, the transformer
decoder, beam search, sequence scores, scheduled sampling, the
label-smoothing loss, the gradient clip and Adam.

Every computation is the plain one: ``torch.stft`` for the spectrum (in
float64, rounded once to float32), a full causal pass of the decoder
over the whole prefix at every beam-search step (no caches), Adam
written out.  Training's scheduled sampling keeps each position's keys
and values, so that each position keeps the dropout it was computed
with: a dropout draws from the default generator, site by site in the
order the recipe's decoder draws, so that a pass started from the same
seed draws the same masks.  ``precision(True)`` runs a block with TF32
products and convolutions: the control, one precision below the
configurations' float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG = -3.0e38                        # a beam's "no candidate" score
MASKED = float(np.finfo(np.float32).min)   # a masked attention score


@contextlib.contextmanager
def precision(tf32: bool):
    """Products and convolutions in float32 (``tf32=False``) or TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def length_mask(lens: torch.Tensor, n: int) -> torch.Tensor:
    """True where position < lens[b], [B, n]."""
    return torch.arange(n, device=lens.device)[None] < lens[:, None]


# ------------------------------------------------------------ log-mel --

@dataclasses.dataclass(frozen=True)
class Mel:
    """torchaudio ``MelSpectrogram`` + ``AmplitudeToDB`` settings."""
    sample_rate: int
    n_fft: int
    hop: int
    n_mels: int
    f_min: float
    f_max: float
    norm: Optional[str]
    mel_scale: str
    top_db: Optional[float]

    def frames(self, samples):
        return samples // self.hop + 1


def _hz_to_mel(f, scale):
    f = np.asarray(f, np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (math.log(6.4) / 27.0), lin)


def _mel_to_hz(m, scale):
    m = np.asarray(m, np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= 15.0, 1000.0 * np.exp(math.log(6.4) / 27.0
                                                * (m - 15.0)),
                    m * (200.0 / 3))


def mel_filterbank(mel: Mel) -> np.ndarray:
    """Triangular filters [n_fft // 2 + 1, n_mels] (torchaudio's)."""
    n_freqs = mel.n_fft // 2 + 1
    freqs = np.linspace(0.0, mel.sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(mel.f_min, mel.mel_scale),
                        _hz_to_mel(mel.f_max, mel.mel_scale), mel.n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel.mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1],
                                    slopes[:, 2:] / f_diff[1:]))
    if mel.norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:mel.n_mels + 2] - f_pts[:mel.n_mels]))[None]
    return fb.astype(np.float32)


def log_mel(wav: torch.Tensor, mel: Mel) -> torch.Tensor:
    """[B, T] -> dB log-mel [B, T // hop + 1, n_mels]: centred frames,
    reflect padding, periodic Hann window, power spectrum, mel filters,
    10 log10(max(., 1e-10)), then each clip floored at its peak - top_db.
    Computed in float64 and rounded once to float32: a random Cnn14 turns
    a float32 spectrum's rounding (3e-4 dB) into 4e-4 of its output, more
    than the program's own error, so the yardstick takes the exact one."""
    spec = torch.stft(wav.double(), mel.n_fft, mel.hop,
                      window=torch.hann_window(mel.n_fft, dtype=torch.float64,
                                               device=wav.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                 # [B, F, frames]
    fb = torch.from_numpy(mel_filterbank(mel)).to(wav.device, torch.float64)
    db = 10.0 * torch.log10(torch.clamp(power.transpose(1, 2) @ fb, min=1e-10))
    if mel.top_db is not None:
        peak = db.amax(dim=(1, 2), keepdim=True)
        db = torch.maximum(db, peak - mel.top_db)
    return db.float()


# ------------------------------------------------------------ decoder --

def sinusoids(n: int, d: int) -> torch.Tensor:
    pe = np.zeros((n, d), np.float32)
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


class Attention(nn.Module):
    """Multi-head attention with ``nn.MultiheadAttention``'s parameters;
    a masked key scores float32's lowest value; in ``train()`` the
    probabilities take dropout at ``p``."""

    def __init__(self, d: int, heads: int, p: float = 0.0):
        super().__init__()
        self.d, self.heads, self.p = d, heads, p
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)

    def proj(self, x, i: int):
        """The query (0), key (1) or value (2) projection of ``x``."""
        d = self.d
        return F.linear(x, self.in_proj_weight[i * d:(i + 1) * d],
                        self.in_proj_bias[i * d:(i + 1) * d])

    def attend(self, q, k, v, key_mask=None, causal=False):
        """Projected q [B, Tq, d] over projected k, v [B, Tk, d]."""
        d, h = self.d, self.heads
        B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
        qh = q.view(B, Tq, h, d // h).transpose(1, 2)
        kh = k.view(B, Tk, h, d // h).transpose(1, 2)
        vh = v.view(B, Tk, h, d // h).transpose(1, 2)
        scores = qh @ kh.transpose(-1, -2) / math.sqrt(d // h)
        if causal:
            scores = scores + torch.triu(torch.full(
                (Tq, Tk), float("-inf"), device=q.device), diagonal=1)
        if key_mask is not None:
            scores = scores.masked_fill(key_mask[:, None, None, :], MASKED)
        probs = F.dropout(torch.softmax(scores, dim=-1), self.p,
                          self.training)
        ctx = probs @ vh
        return self.out_proj(ctx.transpose(1, 2).reshape(B, Tq, d))

    def forward(self, q, kv, key_mask=None, causal=False):
        return self.attend(self.proj(q, 0), self.proj(kv, 1),
                           self.proj(kv, 2), key_mask, causal)


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer with a ReLU feed-forward; in
    ``train()`` dropout at ``p`` on the attention probabilities, the
    three residual branches and the feed-forward's inner activation."""

    def __init__(self, d: int, heads: int, ffn: int, p: float = 0.0):
        super().__init__()
        self.p = p
        self.self_attn = Attention(d, heads, p)
        self.multihead_attn = Attention(d, heads, p)
        self.linear1, self.linear2 = nn.Linear(d, ffn), nn.Linear(ffn, d)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(d) for _ in range(3))

    def drop(self, x):
        return F.dropout(x, self.p, self.training)

    def ffn(self, x):
        return self.drop(self.linear2(self.drop(F.relu(self.linear1(x)))))

    def forward(self, x, memory, pad_mask, mem_mask):
        x = self.norm1(x + self.drop(self.self_attn(x, x, pad_mask,
                                                    causal=True)))
        x = self.norm2(x + self.drop(self.multihead_attn(x, memory,
                                                         mem_mask)))
        return self.norm3(x + self.ffn(x))

    def step(self, x, t: int, cache: Dict, mem_kv, mem_mask, key_mask):
        """Position ``t`` alone, x [B, d]: its key and value go into row
        ``t`` of ``cache`` ({"k", "v"} [B, L, d]), and it attends over
        the rows ``key_mask`` leaves open."""
        sa, ca = self.self_attn, self.multihead_attn
        cache["k"] = put_row(cache["k"], t, sa.proj(x, 1))
        cache["v"] = put_row(cache["v"], t, sa.proj(x, 2))
        a = sa.attend(sa.proj(x[:, None], 0), cache["k"], cache["v"],
                      key_mask)[:, 0]
        x = self.norm1(x + self.drop(a))
        c = ca.attend(ca.proj(x[:, None], 0), *mem_kv, mem_mask)[:, 0]
        x = self.norm2(x + self.drop(c))
        return self.norm3(x + self.ffn(x))


def put_row(cache: torch.Tensor, t: int, row: torch.Tensor) -> torch.Tensor:
    """``cache`` [B, L, ...] with ``row`` [B, ...] at position ``t``, as a
    new tensor (earlier steps' graphs keep the old one)."""
    at = torch.arange(cache.shape[1], device=cache.device) == t
    return torch.where(at.view(1, -1, *([1] * (cache.dim() - 2))),
                       row.unsqueeze(1).to(cache.dtype), cache)


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Pos(nn.Module):
    def __init__(self, n, d):
        super().__init__()
        self.register_buffer("pe", sinusoids(n, d)[:, None, :])


class TransformerDecoder(nn.Module):
    """Word embedding -> dropout -> * sqrt(d) -> + positional table ->
    dropout; the memory projected by Linear -> ReLU -> Dropout ->
    LayerNorm; post-norm layers (d / 64 heads, FFN 4 d); a classifier
    without bias (the embedding when tied).  Every dropout, at ``p``,
    acts in ``train()`` only."""

    def __init__(self, d: int, vocab: int, mem_dim: int, layers: int,
                 tied: bool, p: float = 0.0, max_pos: int = 100):
        super().__init__()
        self.d, self.vocab, self.tied, self.p = d, vocab, tied, p
        self.word_embedding = nn.Embedding(vocab, d)
        self.attn_proj = nn.Sequential(nn.Linear(mem_dim, d), nn.ReLU(),
                                       nn.Dropout(p), nn.LayerNorm(d))
        self.pos_encoder = _Pos(max_pos, d)
        self.model = _Stack([DecoderLayer(d, d // 64, 4 * d, p)
                             for _ in range(layers)])
        if not tied:
            self.classifier = nn.Linear(d, vocab, bias=False)

    def fixed(self, prefix: str) -> Dict[str, torch.Tensor]:
        """Leaves that are not drawn at random: the sinusoidal table."""
        return {f"{prefix}pos_encoder.pe": sinusoids(100, self.d)[:, None, :]}

    def memory(self, attn_emb, attn_len, dropout: bool = True):
        """-> (projected memory, its mask, True = padding); ``dropout``
        False leaves the projection's dropout out."""
        if dropout:
            mem = self.attn_proj(attn_emb)
        else:
            dense, relu, _, norm = self.attn_proj
            mem = norm(relu(dense(attn_emb)))
        return mem, ~length_mask(attn_len, attn_emb.shape[1])

    def embed(self, words, start: int = 0):
        e = F.dropout(self.word_embedding(words), self.p, self.training) \
            * math.sqrt(self.d)
        pe = self.pos_encoder.pe[start:start + words.shape[1], 0][None]
        return F.dropout(e + pe, self.p, self.training)

    def classify(self, x):
        w = (self.word_embedding.weight if self.tied
             else self.classifier.weight)
        return x @ w.t()

    def forward(self, words, memory, mem_mask, pad: int = 0):
        """words [N, T] -> (logits [N, T, V], hidden [N, T, d])."""
        x = self.embed(words)
        for layer in self.model.layers:
            x = layer(x, memory, words == pad, mem_mask)
        return self.classify(x), x

    def step(self, word, t: int, state: Dict, pad: int = 0):
        """The hidden state [N, d] at position ``t`` fed ``word`` [N], over
        ``state`` (``start_steps``), whose caches take this position."""
        L = state["pad"].shape[1]
        state["pad"] = put_row(state["pad"], t, word == pad)
        key_mask = (torch.arange(L, device=word.device)[None] > t) \
            | state["pad"]
        x = self.embed(word[:, None], t)[:, 0]
        for i, layer in enumerate(self.model.layers):
            x = layer.step(x, t, state["cache"][i], state["mem_kv"][i],
                           state["mem_mask"], key_mask)
        return x

    def start_steps(self, memory, mem_mask, length: int) -> Dict:
        """The state of a step-by-step pass over ``length`` positions:
        each layer's memory keys and values, empty self-attention caches."""
        N = memory.shape[0]
        mem_kv = [(layer.multihead_attn.proj(memory, 1),
                   layer.multihead_attn.proj(memory, 2))
                  for layer in self.model.layers]
        cache = [{"k": memory.new_zeros(N, length, self.d),
                  "v": memory.new_zeros(N, length, self.d)}
                 for _ in self.model.layers]
        return {"mem_kv": mem_kv, "cache": cache, "mem_mask": mem_mask,
                "pad": torch.zeros(N, length, dtype=torch.bool,
                                   device=memory.device)}


def rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each row repeated k times (sample-major)."""
    return torch.repeat_interleave(x, k, dim=0)


@torch.no_grad()
def beam_search(dec: TransformerDecoder, memory, mem_mask, max_len: int,
                beam: int, bos: int = 1, eos: int = 2, pad: int = 0):
    """The reference's beam search, temperature 1 -> (best sequence
    [B, L], its score [B], steps run per sample [B]).

    Candidates score log-softmax plus the beam's running score; only
    beam 0 competes at the first step; the K best of K * V by value, ties
    to the lower flat index; a beam that emits <eos>, and every beam at
    the last step, is harvested with its running score over its length;
    the K best harvested (strictly better, in slot order) are kept; an
    ended beam runs on with 1000 taken off; a sample stops once K beams
    were harvested."""
    B, K, L, V = memory.shape[0], beam, max_len, dec.vocab
    dev = memory.device
    mem, mmask = rows(memory, K), rows(mem_mask, K)
    words = torch.full((B, K, 1), bos, dtype=torch.long, device=dev)
    run = torch.zeros(B, K, device=dev)
    seq = torch.full((B, K, L), eos, dtype=torch.long, device=dev)
    done_seq = seq.clone()
    done_score = torch.full((B, K), NEG, device=dev)
    done_count = torch.zeros(B, dtype=torch.long, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = torch.zeros(B, dtype=torch.long, device=dev)
    b_idx = torch.arange(B, device=dev)
    neg = torch.tensor(NEG, device=dev)
    for t in range(L):
        steps += (~stopped).long()
        logits, _ = dec(words.view(B * K, t + 1), mem, mmask, pad)
        lp = torch.log_softmax(logits[:, -1].view(B, K, V), dim=-1)
        total = lp + run[..., None]
        if t == 0:
            total[:, 1:] = NEG
        flat = total.reshape(B, K * V).clone()
        picks, vals = [], []
        for _ in range(K):
            i = torch.argmax(flat, dim=-1)
            picks.append(i)
            vals.append(flat[b_idx, i])
            flat[b_idx, i] = NEG
        idx, new_lp = torch.stack(picks, 1), torch.stack(vals, 1)
        parent, word = idx // V, idx % V
        words = torch.cat([torch.gather(words, 1, parent[..., None].expand(
            B, K, t + 1)), word[..., None]], 2)
        seq = torch.gather(seq, 1, parent[..., None].expand(B, K, L))
        seq[:, :, t] = word
        is_end = (word == eos) | (t == L - 1)
        cand = torch.where(is_end & ~stopped[:, None],
                           new_lp * (1.0 / (t + 1)), neg)
        pool = torch.cat([done_score, cand], 1)
        chosen = torch.zeros(B, 2 * K, dtype=torch.bool, device=dev)
        sel, best = [], []
        for _ in range(K):
            c = torch.where(chosen, neg, pool)
            j = torch.argmax(c, dim=-1)
            sel.append(j)
            best.append(c[b_idx, j])
            chosen[b_idx, j] = True
        both = torch.cat([done_seq, seq], 1)
        done_seq = torch.gather(both, 1, torch.stack(sel, 1)[..., None]
                                .expand(B, K, L))
        done_score = torch.stack(best, 1)
        done_count = done_count + (cand > NEG / 2).sum(1)
        stopped = stopped | (done_count >= K)
        run = torch.where(is_end, new_lp - 1000.0, new_lp)
    return done_seq[:, 0], done_score[:, 0], steps


@torch.no_grad()
def sequence_scores(dec: TransformerDecoder, memory, mem_mask,
                    seq: torch.Tensor, bos: int = 1, eos: int = 2,
                    pad: int = 0) -> torch.Tensor:
    """Each sequence's log-probability, fed one token a step, summed up
    to and including its first <eos> (all of it without one), over that
    length: the score beam search gives a harvested sequence. [N]"""
    N, L = seq.shape
    words = torch.cat([torch.full((N, 1), bos, dtype=torch.long,
                                  device=seq.device), seq[:, :-1].long()], 1)
    logits, _ = dec(words, memory, mem_mask, pad)
    lp = torch.log_softmax(logits, dim=-1).gather(
        -1, seq.long()[..., None])[..., 0]
    ended = torch.cumsum((seq == eos).long(), 1)
    keep = (ended == 0) | ((ended == 1) & (seq == eos))
    return (lp * keep).sum(1) / keep.sum(1)


# ----------------------------------------------------------- training --

def scheduled_sampling(dec: TransformerDecoder, attn_emb, attn_len,
                       cap: torch.Tensor, coins: Sequence[bool],
                       pad: int = 0, bos: int = 1) -> torch.Tensor:
    """The training forward with scheduled sampling -> step logits
    [B, Lc - 1, V].  One teacher-forced pass over cap[:, :-1] (its memory
    projection with dropout); then position by position, fed <bos> and
    then the greedy word of the step before, over the memory projected
    without dropout; step t's logits are the teacher-forced pass's at t
    where coins[t] says "teacher", else this position's.  Without
    dropout, position t of either pass is the decoder over the fed
    prefix (the reference recipe's recompute); with it, each position
    keeps the dropout of the pass that computed it, drawn from the
    default generator site by site."""
    B, Lc = cap.shape
    word = cap[:, :-1]
    memory, mem_mask = dec.memory(attn_emb, attn_len)
    teacher, _ = dec(word, memory, mem_mask, pad)
    memory, _ = dec.memory(attn_emb, attn_len, dropout=False)
    state = dec.start_steps(memory, mem_mask, Lc - 1)
    prev = torch.full((B,), bos, dtype=torch.long, device=cap.device)
    out = []
    for t in range(Lc - 1):
        hidden = dec.step(prev, t, state, pad)
        step = teacher[:, t] if coins[t] else dec.classify(hidden)
        prev = step.detach().argmax(-1)
        out.append(step)
    return torch.stack(out, 1)


def label_smoothing_loss(logits, tgt, tgt_len, smoothing: float):
    """The reference's smoothed cross entropy: target mass 1 - s, the
    rest s / (V - 1) on every other word; mean over valid tokens."""
    V = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1)
    true = torch.full_like(lp, smoothing / (V - 1))
    true.scatter_(-1, tgt[..., None], 1.0 - smoothing)
    loss = -(true * lp).sum(-1)
    mask = length_mask(tgt_len, tgt.shape[1]).float()
    return (loss * mask).sum() / mask.sum()


def exp_decay_lr(base: float, final: float, total: int, warmup: int,
                 count: int) -> float:
    """Linear warm-up, then exponential decay to ``final`` at ``total``;
    ``count`` updates already applied."""
    it = count + 1
    if it <= warmup:
        return base * it / warmup
    return base * (final / base) ** ((it - warmup) / (total - warmup))


class Adam:
    """Adam with L2 weight decay added to the gradient, bias-corrected
    moments, eps outside the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params, self.betas, self.eps, self.wd = params, betas, eps, \
            weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float
             ) -> Dict[str, torch.Tensor]:
        """-> the gradients as the moments took them (with the decay)."""
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        seen = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            seen[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
        return seen


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale every gradient by min(1, max_norm / (norm + 1e-6)), the norm
    taken over all of them in float64 -> the raw norm."""
    norm = torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values()))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0).float()
    for g in grads.values():
        g.mul_(coef)
    return norm
