"""Tensor parallelism of the transformer decoder over a [data, model] grid
of ranks (counterpart of ``audiocaption_tpu/parallel/tp.py``).

The JAX package expresses the Megatron layout as parameter shardings and
lets GSPMD insert the collectives; here the layout is written out.  Over
the model-parallel group of a rank (``make_tp_groups``):

  * the attention q / k / v projections (``in_proj_*``, each third) are
    column-parallel, a rank holding whole heads, and the output
    projection is row-parallel: one all-reduce a layer's attention;
  * the FFN's ``linear1`` is column-parallel and ``linear2`` row-parallel:
    one all-reduce;
  * the word embedding is vocabulary-parallel (each rank looks up its rows,
    one all-reduce) and the classifier is sharded over the vocabulary (its
    logits gathered for the loss).

A column-parallel product copies its replicated input in and sums its
gradient over the group on the way back; a row-parallel one sums its
output over the group.  The encoder and the other parameters stay
replicated, their gradients equal on every rank of the group.  Where a
dimension does not split evenly (the vocabulary over the group, the
heads, the FFN width), that parameter stays replicated, as JAX's
``shard_params`` leaves it (tp.py:98-107); a tied classifier keeps the
embedding replicated.  :func:`shard_params` returns the sharded
parameters, which :class:`TensorParallelContext` (the train step's
context over the grid) counts once each in the gradient norm.  No entry
point of the package shards a model: the runner trains data parallel
only, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from audiocaption_tpu_torch.models.layers import (
    Linear, MultiheadAttention, as_compute, dense)
from audiocaption_tpu_torch.parallel.mesh import ParallelContext, grads_norm

# parameter-name regex -> the dimension of the torch tensor sharded over
# the model-parallel group (torch's Linear weight is [out, in], flax's
# kernel [in, out]: JAX's P(None, "model") on a kernel is dimension 0
# here); first match wins, no match stays replicated.  A column-parallel
# product's bias goes with its weight; a row-parallel one's stays whole.
DEFAULT_TP_RULES: List[Tuple[str, int]] = [
    (r".*word_embedding\.weight$", 0),
    (r".*classifier\.weight$", 0),
    (r".*classifier\.bias$", 0),
    (r".*(self_attn|multihead_attn)\.in_proj_weight$", 0),
    (r".*(self_attn|multihead_attn)\.in_proj_bias$", 0),
    (r".*(self_attn|multihead_attn)\.out_proj\.weight$", 1),
    (r".*linear1\.weight$", 0),
    (r".*linear1\.bias$", 0),
    (r".*linear2\.weight$", 1),
]


def tp_spec_for(name: str, rules: Optional[Sequence] = None
                ) -> Optional[int]:
    """The sharded dimension of parameter ``name``, or None."""
    for pattern, dim in (rules if rules is not None else DEFAULT_TP_RULES):
        if re.match(pattern, name):
            return dim
    return None


def make_tp_groups(world_size: int, model_parallel: int):
    """The [world / model_parallel, model_parallel] grid of ranks (rank r
    at data row r // model_parallel, model column r % model_parallel, as
    JAX's ``make_tp_mesh`` reshapes its devices) -> (this rank's
    data-parallel group, its model-parallel group).  Every rank calls it:
    ``dist.new_group`` is collective."""
    if world_size % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the world of {world_size}")
    rank = dist.get_rank()
    dp_n = world_size // model_parallel
    dp_group = tp_group = None
    for t in range(model_parallel):
        ranks = [d * model_parallel + t for d in range(dp_n)]
        g = dist.new_group(ranks)
        if rank in ranks:
            dp_group = g
    for d in range(dp_n):
        ranks = [d * model_parallel + t for t in range(model_parallel)]
        g = dist.new_group(ranks)
        if rank in ranks:
            tp_group = g
    return dp_group, tp_group


@dataclasses.dataclass
class TensorParallelContext(ParallelContext):
    """The train step's context on the [data, model] grid: the
    data-parallel group (``dp_group``), the model-parallel group and the
    parameters sharded over it (:func:`shard_params`)."""
    tp_group: Any = None
    sharded: frozenset = frozenset()     # ids of the sharded parameters

    def grad_norm(self, params: List[nn.Parameter],
                  dtype: torch.dtype) -> torch.Tensor:
        """The global norm of the gradients: a sharded parameter's square
        summed over the model-parallel group, a replicated one's counted
        once."""
        grads = [p for p in params if p.grad is not None]
        rep = grads_norm([p.grad for p in grads if id(p) not in
                          self.sharded], dtype, params[0].device)
        sq = grads_norm([p.grad for p in grads if id(p) in self.sharded],
                        dtype, params[0].device) ** 2
        dist.all_reduce(sq, group=self.tp_group)
        return torch.sqrt(rep ** 2 + sq)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    """Concatenate the ranks' last dimensions forward; each rank's slice
    of the gradient back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank, n = dist.get_rank(group), dist.get_world_size(group)
        ctx.width = x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


class ColumnParallelLinear(Linear):
    """A ``layers.Linear`` holding output rows [lo, hi) of the full
    weight; its input copied in over ``tp_group``; the full output
    gathered where ``gather_output``."""
    tp_group = None
    gather_output = False

    def forward(self, x):
        y = dense(_CopyToGroup.apply(x, self.tp_group), self.weight,
                  self.bias, self.compute_dtype)
        return _GatherFromGroup.apply(y, self.tp_group) \
            if self.gather_output else y


class RowParallelLinear(Linear):
    """A ``layers.Linear`` holding input columns [lo, hi): the partial
    products summed over ``tp_group``, then the (replicated) bias."""
    tp_group = None

    def forward(self, x):
        y = _ReduceFromGroup.apply(dense(x, self.weight, None,
                                         self.compute_dtype), self.tp_group)
        return y if self.bias is None else y + as_compute(
            self.bias, self.compute_dtype)


class VocabParallelEmbedding(nn.Embedding):
    """An ``nn.Embedding`` holding rows [vocab_lo, vocab_lo + its rows):
    ids outside them look up zeros, and the ranks' lookups are summed."""
    tp_group = None
    vocab_lo = 0

    def forward(self, ids):
        local = ids - self.vocab_lo
        inside = (local >= 0) & (local < self.num_embeddings)
        e = F.embedding(local.clamp(0, self.num_embeddings - 1), self.weight)
        return _ReduceFromGroup.apply(e * inside[..., None].to(e.dtype),
                                      self.tp_group)


class TPMultiheadAttention(MultiheadAttention):
    """A ``layers.MultiheadAttention`` holding ``num_heads`` of the full
    heads (``in_proj_*``: the q, k and v rows of those heads) and a
    row-parallel ``out_proj``; inputs copied in over ``tp_group``."""
    tp_group = None

    def _proj(self, x, i):
        return super()._proj(_CopyToGroup.apply(x, self.tp_group), i)


def _shard(t: torch.Tensor, dim: int, rank: int, n: int,
           thirds: bool = False) -> torch.Tensor:
    """Rank ``rank``'s part of ``t`` along ``dim`` (of each third of it
    for a packed q / k / v tensor)."""
    if thirds:
        return torch.cat([_shard(p, dim, rank, n)
                          for p in t.chunk(3, dim)], dim)
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).clone()


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    old = getattr(module, name)
    setattr(module, name, nn.Parameter(value, requires_grad=old.requires_grad))


def shard_params(model: nn.Module, tp_group,
                 rules: Optional[Sequence] = None) -> Set[int]:
    """Shard the decoder of ``model`` (in place) over ``tp_group`` by
    ``rules`` (:data:`DEFAULT_TP_RULES`): each transformer layer's
    attentions and FFN, the word embedding and the classifier, where
    their dimensions split evenly.  Build the optimizer after this.  ->
    the ids of the sharded parameters (for
    ``TensorParallelContext.sharded``)."""
    rank, n = dist.get_rank(tp_group), dist.get_world_size(tp_group)
    sharded: Set[int] = set()

    def rule(prefix):
        return tp_spec_for(prefix, rules)

    def column(mod, gather=False):
        mod.__class__ = ColumnParallelLinear
        mod.tp_group, mod.gather_output = tp_group, gather
        _set_param(mod, "weight", _shard(mod.weight.data, 0, rank, n))
        sharded.add(id(mod.weight))
        if mod.bias is not None:
            _set_param(mod, "bias", _shard(mod.bias.data, 0, rank, n))
            sharded.add(id(mod.bias))
        mod.out_features = mod.weight.shape[0]

    def row(mod):
        mod.__class__ = RowParallelLinear
        mod.tp_group = tp_group
        _set_param(mod, "weight", _shard(mod.weight.data, 1, rank, n))
        sharded.add(id(mod.weight))
        mod.in_features = mod.weight.shape[1]

    for name, mod in model.named_modules():
        if isinstance(mod, MultiheadAttention) \
                and rule(name + ".in_proj_weight") == 0 \
                and rule(name + ".out_proj.weight") == 1 \
                and mod.num_heads % n == 0:
            mod.__class__ = TPMultiheadAttention
            mod.tp_group = tp_group
            _set_param(mod, "in_proj_weight",
                       _shard(mod.in_proj_weight.data, 0, rank, n, True))
            _set_param(mod, "in_proj_bias",
                       _shard(mod.in_proj_bias.data, 0, rank, n, True))
            sharded.update({id(mod.in_proj_weight), id(mod.in_proj_bias)})
            mod.embed_dim //= n
            mod.num_heads //= n
            row(mod.out_proj)
        elif hasattr(mod, "linear1") and hasattr(mod, "linear2") \
                and rule(name + ".linear1.weight") == 0 \
                and rule(name + ".linear2.weight") == 1 \
                and mod.linear1.out_features % n == 0:
            column(mod.linear1)
            row(mod.linear2)
        elif hasattr(mod, "word_embedding") \
                and isinstance(mod.word_embedding, nn.Embedding) \
                and mod.word_embedding.num_embeddings % n == 0:
            tied = getattr(mod, "tie_weights", False)
            emb = mod.word_embedding
            if rule(name + ".word_embedding.weight") == 0 and not tied:
                emb.__class__ = VocabParallelEmbedding
                emb.tp_group = tp_group
                emb.vocab_lo = rank * (emb.num_embeddings // n)
                _set_param(emb, "weight", _shard(emb.weight.data, 0, rank, n))
                emb.num_embeddings = emb.weight.shape[0]
                sharded.add(id(emb.weight))
            cls = getattr(mod, "classifier", None)
            if isinstance(cls, Linear) and not tied \
                    and rule(name + ".classifier.weight") == 0:
                column(cls, gather=True)
    return sharded


def full_state_dict(model: nn.Module, tp_group) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with every sharded tensor gathered over
    ``tp_group`` into its full shape (the single-process key space)."""
    n = dist.get_world_size(tp_group)
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            dim, thirds = None, False
            if isinstance(mod, TPMultiheadAttention) and pname.startswith(
                    "in_proj"):
                dim, thirds = 0, True
            elif isinstance(mod, ColumnParallelLinear):
                dim = 0
            elif isinstance(mod, RowParallelLinear) and pname == "weight":
                dim = 1
            elif isinstance(mod, VocabParallelEmbedding):
                dim = 0
            t = p.detach()
            if dim is not None:
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t.contiguous(), group=tp_group)
                if thirds:
                    t = torch.cat([torch.cat([q.chunk(3, 0)[i] for q in parts])
                                   for i in range(3)])
                else:
                    t = torch.cat(parts, dim)
            out[key] = t
    for key, b in model.named_buffers():
        out[key] = b.detach()
    return out
