"""Sharding rules: DP(+FSDP) x TP(+SP) x EP, pod axis = outer DP (the port of
``repro.parallel.sharding``).

The logical scheme (MaxText-style 2D + sequence parallelism):

* batch dims            -> ("pod", "data")           [DP; pod = outer DP]
* residual seq dim      -> "model"                   [SP between blocks]
* attention heads       -> "model"  (uneven when the head count is)
* ffn hidden / experts  -> "model"  (EP when num_experts % |model| == 0)
* parameters            -> one dim over "data" (FSDP), one over "model" (TP)
* kv-cache sequence     -> "model"

The rules and their resolution are the reference's, pure functions of
shapes and axis sizes: ``_resolve`` returns the reference's
``PartitionSpec`` as a tuple (one entry a tensor dim: None, an axis name,
or a tuple of axis names, major to minor), so both packages' specs
compare entry for entry.  A "mesh" here is anything with ``axis_names``
and ``shape`` (a dict of axis sizes), or a ``DeviceMesh`` (``mesh_axes``
reads its dim names and sizes).

``placements`` turns a resolved spec into DTensor placements over a
``DeviceMesh``: a tensor dim sharded over several axes becomes one
``Shard(d)`` on each of their mesh dims.  DTensor splits a dim by its mesh
dims in order, the first one outermost, so an axis tuple given in the
mesh's order (every rule's is) gives each rank the slice the reference's
major-to-minor tuple gives it whenever the dim divides the axes' product.
Where it does not (only the ``UNEVEN_OK`` names keep such an axis), one
axis splits it as the reference does (chunks of ceil(n / size), the last
ones short or empty); over two or more axes the two nest differently
(the reference pads the product, DTensor each axis in turn), which no rule
here produces: ``placements`` raises for it.

``make_shard_fn(mesh, rules)`` returns ``shard(x, name)`` for the model
code: the identity without a mesh (or a mesh of one device), else it
redistributes a DTensor to the placements its rule resolves to.  With no
mesh, every path runs on plain tensors, as before.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch

__all__ = ["ShardingRules", "make_shard_fn", "param_specs", "batch_spec",
           "state_specs", "make_param_rule", "cache_rule", "UNEVEN_OK", "DP",
           "mesh_axes", "placements", "distribute", "spec_of", "spec_leaves",
           "is_dtensor", "global_offset", "Placed", "named", "from_whole",
           "mesh_context", "replicate_like", "unshard_pod", "grad_as_forward"]

# activation names whose "model"-axis sharding may be uneven
UNEVEN_OK = frozenset({"heads", "moe_experts"})

DP = ("pod", "data")     # flattened data-parallel axes (pod absent -> data)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """name -> partition template (axis names or None per dim)."""
    rules: Mapping[str, tuple]

    @staticmethod
    def fsdp_only(dp_axes: tuple = DP) -> "ShardingRules":
        """Pure-FSDP profile: batch sharded over EVERY axis (data, model and
        pod all act as data parallelism), parameters 2D-sharded and gathered
        just in time per layer, no tensor parallelism.  Selected per arch by
        ``ModelConfig.sharding_profile``."""
        dp = tuple(a for a in dp_axes) + ("model",)
        base = dict(ShardingRules.default(dp_axes).rules)
        base.update({
            "act_btd":      (dp, None, None),
            "act_btd_full": (dp, None, None),
            "heads":        (dp, None, None, None),
            "attn_q_seq":   (dp, None, None, None, None),
            "attn_kv_rep":  (dp, None, None, None),
            "attn_acc_seq": (dp, None, None, None, None),
            "attn_out":     (dp, None, None, None),
            "ffn_hidden":   (dp, None, None),
            "logits":       (dp, None, None),
            "cache_kv":     (dp, "model", None, None),
            "rnn_state":    (dp, None),
            "moe_experts":  ("model", None, None, None),
            "moe_tokens":   (dp, None, None),
        })
        return ShardingRules(rules=base)

    @staticmethod
    def profile(name: str, dp_axes: tuple = DP) -> "ShardingRules":
        if name == "fsdp":
            return ShardingRules.fsdp_only(dp_axes)
        return ShardingRules.default(dp_axes)

    @staticmethod
    def default(dp_axes: tuple = DP) -> "ShardingRules":
        dp = dp_axes
        return ShardingRules(rules={
            # activations ----------------------------------------------------
            "act_btd":      (dp, "model", None),        # residual, SP on seq
            "act_btd_full": (dp, None, None),           # gathered residual
            "heads":        (dp, None, "model", None),  # [B, L, H, Dh]
            "attn_q_seq":   (dp, "model", None, None, None),  # [B,Lq,Hkv,g,D]
            "attn_kv_rep":  (dp, None, None, None),     # k/v replicated
            "attn_acc_seq": (dp, None, None, "model", None),  # [B,Hkv,g,Lq,D]
            "attn_out":     (dp, "model", None, None),  # [B, Lq, Hq, Dh]
            "ffn_hidden":   (dp, None, "model"),        # [B, L, F]
            "logits":       (dp, None, "model"),        # [B, L, V]
            "cache_kv":     (dp, "model", None, None),  # [B, Smax, Hkv, Dh]
            "rnn_state":    (dp, "model"),               # [B, D_rnn]
            "moe_experts":  ("model", None, None, None),  # [E, Gn, C, D] (EP)
            "moe_tokens":   (dp, None, None),             # [Gn, G, D]
            # parameters ------------------------------------------------------
            "p_emb":        (None, ("data", "model")),   # [V, D]  (lookup)
            "p_head":       ("data", "model"),           # [D, Vp] (logits)
            "p_norm":       (None,),
            "p_df":         ("data", "model"),           # [D, F]-like matrices
            "p_fd":         ("model", "data"),           # [F, D]-like matrices
            "p_bias":       ("model",),
            "p_router":     ("data", None),              # [D, E]
            "p_moe_dff":    (None, "data", "model"),     # [E, D, F]
            "p_moe_ffd":    (None, "model", "data"),     # [E, F, D]
            "p_moe_edff":   ("model", "data", None),     # [E, D, F] (EP)
            "p_moe_effd":   ("model", None, "data"),     # [E, F, D] (EP)
            "p_conv":       (None, "model"),             # [W, D_rnn]
            "p_vec":        ("model",),                  # [D_rnn]-like vectors
            "p_mu":         (None, "model"),             # [7, D] rwkv lerps
            # serving state ---------------------------------------------------
            "c_kv":         (None, dp, "model", None, None),  # [L,B,S,H,Dh]
            "c_rwkv_s":     (None, dp, "model", None, None),  # [L,B,H,n,n]
            "c_vec":        (None, dp, None),                 # [L, B, D]
            "c_ring_kv":    (dp, None, None, None),           # [B, W, Hkv, Dh]
            "c_rnn_h":      (dp, "model"),                    # [B, D_rnn]
            "c_conv":       (dp, None, "model"),              # [B, W-1, D_rnn]
            "c_scalar":     (),
        })


@dataclasses.dataclass(frozen=True)
class _Axes:
    axis_names: tuple
    shape: dict
    size: int


def mesh_axes(mesh):
    """``mesh`` as an object with ``axis_names``, ``shape`` (a dict of axis
    sizes) and ``size``: a ``DeviceMesh`` is read through its dim names; any
    other object (the tests' ``FakeMesh``) is returned as it is."""
    if mesh is None or hasattr(mesh, "axis_names"):
        return mesh
    names = tuple(mesh.mesh_dim_names or ())
    sizes = tuple(mesh.shape)
    if len(names) != len(sizes):
        raise ValueError("mesh_axes: a DeviceMesh needs mesh_dim_names")
    return _Axes(names, dict(zip(names, sizes)), int(mesh.size()))


def _resolve(template: tuple, shape: tuple[int, ...], mesh,
             uneven_ok: bool, leading: int = 0) -> tuple:
    """Turn a rule template into a spec valid for ``shape``.

    ``leading`` extra unsharded dims are prepended (stacked-layer params)."""
    mesh = mesh_axes(mesh)
    spec: list = [None] * leading
    tdims = template[-(len(shape) - leading):] if len(shape) > leading else ()
    for dim_size, axes in zip(shape[leading:], tdims):
        if axes is None:
            spec.append(None)
            continue
        ax_tuple = axes if isinstance(axes, tuple) else (axes,)
        ax_tuple = tuple(a for a in ax_tuple if a in mesh.axis_names)
        if not ax_tuple:
            spec.append(None)
            continue
        n = 1
        for a in ax_tuple:
            n *= mesh.shape[a]
        if dim_size % n == 0:
            spec.append(ax_tuple if len(ax_tuple) > 1 else ax_tuple[0])
        elif uneven_ok and dim_size >= n // 2:
            spec.append(ax_tuple if len(ax_tuple) > 1 else ax_tuple[0])
        else:
            spec.append(None)
    # PartitionSpec(*spec) drops nothing, so neither does the tuple
    return tuple(spec)


def spec_of(rules: "ShardingRules", name: str, shape, mesh) -> tuple | None:
    """The resolved spec of activation ``name`` at ``shape`` (None when no
    rule has that name)."""
    template = rules.rules.get(name)
    if template is None:
        return None
    return _resolve(template, tuple(shape), mesh, uneven_ok=name in UNEVEN_OK)


def placements(spec: tuple, device_mesh, shape=None) -> list:
    """DTensor placements over ``device_mesh`` for a resolved ``spec``: one
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` is split over,
    ``Replicate()`` on the rest.  ``shape``, when given, is checked: a dim
    that does not divide the product of two or more axes raises (DTensor
    and the reference would place its rows differently; see the module
    docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: axes {axes} are not in the "
                             f"mesh's order {names}")
        if shape is not None and len(axes) > 1:
            n = 1
            for i in idx:
                n *= device_mesh.shape[i]
            if shape[d] % n:
                raise ValueError(f"placements: dim {d} of {tuple(shape)} "
                                 f"does not divide {axes}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"placements: axis {names[i]} used twice "
                                 f"in {spec}")
            out[i] = Shard(d)
    return out


def make_shard_fn(mesh, rules: ShardingRules | None = None):
    """Returns ``shard(x, name)``: ``x`` redistributed to the placements
    its rule resolves to at ``x``'s shape, over ``x``'s own mesh (``mesh``
    or a sub-mesh of it: a pod's (data, model) mesh in the multi-pod train
    step).  The identity without a mesh or on a mesh of one device (as the
    reference's), for a name with no rule, and for a plain tensor.

    ``mesh`` is a ``DeviceMesh``."""
    if mesh is None or mesh.size() == 1:
        return lambda x, name: x
    rules = rules or ShardingRules.default()
    from torch.distributed.tensor import DTensor

    def shard(x, name: str):
        if not isinstance(x, DTensor):
            return x
        m = x.device_mesh
        spec = spec_of(rules, name, x.shape, m)
        if spec is None:
            return x
        want = placements(spec, m, x.shape)
        if list(x.placements) == want:
            return x
        return _redistribute(x, m, want)

    return shard


def _uneven(shape, device_mesh, pls) -> bool:
    """Whether ``pls`` split a dim of ``shape`` into unequal parts."""
    for d in {p.dim for p in pls if p.is_shard()}:
        n = 1
        for i, p in enumerate(pls):
            if p.is_shard(d):
                n *= device_mesh.size(i)
        if shape[d] % n:
            return True
    return False


def _redistribute(x, device_mesh, want):
    """``x.redistribute(device_mesh, want)``, through a whole dim where a
    mesh dim's split moves from one tensor dim to another and either split
    is uneven (heads that do not divide the model axis): DTensor's direct
    move (an all-to-all) gives the ranks parts of unequal sizes, in the
    forward and in the backward, and the collective fails.  The gradient
    of the whole step comes back whole (``grad_as_forward``)."""
    from torch.distributed.tensor import Replicate
    cur = list(x.placements)
    moves = [i for i, (c, w) in enumerate(zip(cur, want))
             if c.is_shard() and w.is_shard() and c.dim != w.dim]
    if moves and (_uneven(x.shape, device_mesh, cur)
                  or _uneven(x.shape, device_mesh, want)):
        x = grad_as_forward(x.redistribute(device_mesh, [
            Replicate() if i in moves else c for i, c in enumerate(cur)]))
    return x.redistribute(device_mesh, want)


class _GradAsForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def grad_as_forward(x):
    """DTensor ``x`` as it is, its gradient placed as ``x`` is.  DTensor's
    backward of a redistribution out of a whole tensor leaves the gradient
    split as the redistribution's output was; where that split is uneven,
    a view of it or a move of it to another dim comes out with sizes that
    do not match across ranks, so a whole tensor that feeds one is kept
    whole in the backward too."""
    return _GradAsForward.apply(x)


def param_specs(params_shapes, mesh, name_of,
                rules: ShardingRules | None = None):
    """A tree of resolved specs for a tree of tensors (shapes are read;
    meta tensors will do), one per leaf; ``name_of(path) -> (rule_name,
    n_leading_unsharded_dims)`` maps each leaf's path (``tree.paths``) to
    its rule.  None leaves without a mesh."""
    from repro_torch import tree as tree_lib
    if mesh is None:
        return tree_lib.map_tree(lambda _: None, params_shapes)
    rules = rules or ShardingRules.default()

    def one(path, leaf):
        rule_name, leading = name_of(path)
        return _resolve(rules.rules[rule_name], tuple(leaf.shape), mesh,
                        uneven_ok=False, leading=leading)

    return _map_with_path(one, params_shapes)


def batch_spec(mesh, ndim: int = 2) -> tuple | None:
    """Spec of [B, ...] host data: batch over (pod, data)."""
    if mesh is None:
        return None
    mesh = mesh_axes(mesh)
    dp = tuple(a for a in DP if a in mesh.axis_names)
    return (dp,) + (None,) * (ndim - 1)


# --------------------------------------------------------------------------
# parameter / state rule assignment by tree path
# --------------------------------------------------------------------------

_PARAM_RULE_OF = {
    "emb": "p_emb", "head": "p_head", "final_norm": "p_norm",
    "ln1": "p_norm", "ln2": "p_norm", "ln_x": "p_vec",
    "wq": "p_df", "wk": "p_df", "wv": "p_df", "wg": "p_df", "wu": "p_df",
    "w_r": "p_df", "w_k": "p_df", "w_v": "p_df", "w_g": "p_df",
    "wk2": "p_df", "wr2": "p_df", "w_gate_in": "p_df", "w_rnn_in": "p_df",
    "w_a": "p_df", "w_x": "p_df", "decay_a": "p_df", "w_patch": "p_df",
    "wo": "p_fd", "wd": "p_fd", "wv2": "p_fd", "w_o": "p_fd",
    "decay_b": "p_fd", "w_out": "p_fd",
    "bq": "p_bias", "bk": "p_bias", "bv": "p_bias",
    "conv_b": "p_vec", "b_a": "p_vec", "b_x": "p_vec", "lam": "p_vec",
    "decay_base": "p_vec", "bonus": "p_vec",
    "conv_w": "p_conv", "mu": "p_mu", "router": "p_router",
}

_CACHE_RULE_OF = {
    "k": "c_kv", "v": "c_kv", "s": "c_rwkv_s",
    "shift1": "c_vec", "shift2": "c_vec", "pos": "c_scalar",
    "h": "c_rnn_h", "conv": "c_conv",
    "step": "c_scalar", "loss": "c_scalar", "aux_loss": "c_scalar",
    "grad_norm": "c_scalar",
}


def _path_keys(path) -> list:
    """A leaf's path as its keys: a ``tree.paths`` string
    (``['blocks']['wq']``, ``[0]``) or a list of keys already read.  A
    dict key stays a string, a list index becomes an int: ``leading``
    depends on telling them apart."""
    if isinstance(path, (list, tuple)):
        return list(path)
    keys: list = []
    i = 0
    while i < len(path):
        if path[i] != "[":
            raise ValueError(f"_path_keys: bad path {path!r}")
        j = path.index("]", i)
        body = path[i + 1:j]
        if body[:1] in "'\"":
            # a dict key in repr() form: find its closing quote
            q = body[0]
            end = path.index(q + "]", i + 2)
            keys.append(path[i + 2:end])
            i = end + 2
            continue
        keys.append(int(body))
        i = j + 1
    return keys


def make_param_rule(expert_parallel: bool = False):
    """name_of(path) for param_specs.  ``expert_parallel`` switches the MoE
    expert-weight layout (EP needs num_experts % |model| == 0)."""
    moe = {
        "we_gate": "p_moe_edff" if expert_parallel else "p_moe_dff",
        "we_up": "p_moe_edff" if expert_parallel else "p_moe_dff",
        "we_down": "p_moe_effd" if expert_parallel else "p_moe_ffd",
    }

    def name_of(path):
        keys = _path_keys(path)
        # stacked-on-L params live under a dict "blocks" with NO list index;
        # per-layer list params (the hybrid) have an integer in the path.
        stacked = ("blocks" in keys) and not any(
            isinstance(k, int) for k in keys)
        leading = 1 if stacked else 0
        last = next(k for k in reversed(keys) if isinstance(k, str))
        rule = moe.get(last) or _PARAM_RULE_OF.get(last)
        if rule is None:
            raise KeyError(f"no sharding rule for param path {keys}")
        return rule, leading

    return name_of


def cache_rule(path):
    """name_of(path) for decode-cache / metric trees: ``(rule, 0)`` for
    every leaf, as the reference returns (the stacked-on-L rules c_kv,
    c_rwkv_s and c_vec carry the L dim in their templates); the hybrid's
    per-layer list entries take c_ring_kv / c_rnn_h / c_conv."""
    keys = _path_keys(path)
    last = next(k for k in reversed(keys) if isinstance(k, str))
    per_layer_list = any(isinstance(k, int) for k in keys)
    if per_layer_list:
        rule = {"k": "c_ring_kv", "v": "c_ring_kv", "h": "c_rnn_h",
                "conv": "c_conv"}.get(last, _CACHE_RULE_OF.get(last))
        return rule, 0
    rule = _CACHE_RULE_OF.get(last)
    if rule is None:
        raise KeyError(f"no cache rule for path {keys}")
    return rule, 0


def _map_with_path(fn, tree):
    from repro_torch import tree as tree_lib
    return tree_lib.unflatten(tree, [
        fn(_path_keys(p), leaf) for p, leaf in zip(tree_lib.paths(tree),
                                                   tree_lib.leaves(tree))])


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def state_specs(tree_shapes, mesh, kind: str = "param",
                expert_parallel: bool = False,
                rules: ShardingRules | None = None):
    """Resolved specs for params ("param"), optimizer state ("opt": the
    params' rules under m / v, a replicated step, and the pod-leading
    ef_error), or decode caches ("cache"); None leaves without a mesh.  A
    leaf with no shape (the cache's ``pos`` int) resolves to ()."""
    from repro_torch import tree as tree_lib
    if mesh is None:
        return tree_lib.map_tree(lambda _: None, tree_shapes)
    mesh = mesh_axes(mesh)
    rules = rules or ShardingRules.default()
    prule = make_param_rule(expert_parallel)

    def one(keys, leaf):
        shape = _shape(leaf)
        if kind == "cache":
            rule, leading = cache_rule(keys)
        elif keys and keys[0] == "ef_error":
            rule, leading = prule(keys[1:])
            spec = _resolve(rules.rules[rule], shape[1:], mesh,
                            uneven_ok=False, leading=leading)
            pod = "pod" if "pod" in mesh.axis_names else None
            return (pod,) + spec
        elif keys and keys[0] in ("m", "v"):
            rule, leading = prule(keys[1:])
        elif keys and keys[0] == "step":
            return ()
        else:
            rule, leading = prule(keys)
        return _resolve(rules.rules[rule], shape, mesh, uneven_ok=False,
                        leading=leading)

    return _map_with_path(one, tree_shapes)


def distribute(tree, specs, device_mesh):
    """Each tensor leaf of ``tree`` as a DTensor over ``device_mesh``, placed
    by its spec in ``specs`` (``state_specs``' tree of the same shape).
    Every rank passes the same full tensor and keeps a copy of its slice
    (``from_whole``); a DTensor leaf (on ``device_mesh``) is redistributed.
    Non-tensor leaves are kept as they are."""
    from repro_torch import tree as tree_lib

    def one(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        pl = placements(spec, device_mesh, x.shape)
        if is_dtensor(x):
            return x if list(x.placements) == pl else \
                x.redistribute(device_mesh, pl)
        return from_whole(x, device_mesh, pl)

    return tree_lib.unflatten(tree, [
        one(x, spec) for x, spec in zip(tree_lib.leaves(tree),
                                        spec_leaves(tree, specs))])


def from_whole(x: torch.Tensor, device_mesh, pls):
    """Whole tensor ``x`` (the same on every rank) as a DTensor placed by
    ``pls``: a copy of this rank's slice, cut locally, so that no rank
    keeps ``x``'s storage alive once the caller drops it.
    ``distribute_tensor`` scatters from one rank instead, a collective
    that gloo does not take for CUDA tensors (two ranks on one card
    crashed in it)."""
    from torch.distributed.tensor import DTensor
    shape, off = _local_box(x.shape, device_mesh, pls)
    local = x[tuple(slice(o, o + n) for o, n in zip(off, shape))]
    local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, device_mesh, pls,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def spec_leaves(tree, specs) -> list:
    """The specs of ``specs`` (a tree shaped like ``tree`` whose leaves are
    spec tuples) in ``tree.leaves(tree)``'s order: walked by ``tree``'s
    structure, since a spec is itself a tuple."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k],
                                                              specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t, sp in zip(tree, specs) for s in spec_leaves(t, sp)]
    return [specs]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False where torch has no distributed
    package)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def global_offset(x) -> tuple:
    """Where this rank's local slice of DTensor ``x`` starts in each dim."""
    return tuple(_local_box(x.shape, x.device_mesh, x.placements)[1])


def _local_box(shape, device_mesh, pls) -> tuple:
    """(local shape, global offset) of this rank's slice.  DTensor reads
    the rank's coordinate through a tensor op, which ``FakeTensorMode``
    (the dry run's trace) refuses as data-dependent: it runs outside the
    mode, on the real coordinate."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(shape, device_mesh, pls)


def mesh_context(tree):
    """DTensor's implicit replication when a leaf of ``tree`` is a DTensor
    (the model's plain constants, rope tables and masks, then enter as
    replicated), else a no-op context."""
    from repro_torch import tree as tree_lib
    if any(is_dtensor(x) for x in tree_lib.leaves(tree)):
        return _implicit_replication()
    return contextlib.nullcontext()


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication`` that
    restores the flag it found (that one clears it on exit, which would end
    an enclosing context early)."""
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def replicate_like(t, x):
    """Plain tensor ``t`` (the same on every rank) as a replicated DTensor
    on DTensor ``x``'s mesh; a DTensor ``t`` as it is."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


@dataclasses.dataclass(frozen=True)
class Placed:
    """A leaf's place on a mesh: a ``DeviceMesh`` and a resolved spec (the
    reference's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    def place(self, x: torch.Tensor):
        """Whole tensor ``x`` (the same on every rank) as a DTensor."""
        return from_whole(x, self.mesh,
                          placements(self.spec, self.mesh, x.shape))


def named(specs_tree, device_mesh, like):
    """``Placed`` leaves over ``device_mesh`` for a tree of specs
    (``state_specs``' output) shaped like tree ``like``."""
    from repro_torch import tree as tree_lib
    return tree_lib.unflatten(like, [
        Placed(device_mesh, s) for s in spec_leaves(like, specs_tree)])


def unshard_pod(x):
    """[npod, ...] DTensor ``x`` whole over "pod", its other dims as they
    are: the launcher's ``unshard_pod`` for
    ``optim.compress.ef_compress_mean`` (the reference replicates only the
    pod dim by a sharding constraint)."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if n == "pod" else p
        for n, p in zip(x.device_mesh.mesh_dim_names, x.placements)])
