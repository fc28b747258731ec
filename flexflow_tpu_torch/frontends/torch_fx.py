"""PyTorch frontend: torch.fx symbolic trace -> FFModel graph
(counterpart of flexflow_tpu/frontends/torch_fx.py).

`PyTorchModel` traces a torch.nn.Module with torch.fx (RMSNorm-family
modules kept whole, as one RMS_NORM op) and `torch_to_ff` replays the
traced graph as FFModel layer calls; a module called at several sites
becomes several layers. `copy_weights` pushes the module's parameters
into the compiled model (nn.Linear stores (out, in), transposed to the
dense kernel's (in, out); Conv2d's OIHW matches; LSTM gate weights
transposed and its two biases summed), straight from torch tensors on any
device. A text IR (`torch_to_file` / `file_to_ff`, the JAX package's
format) rebuilds the graph where the module's code is not at hand.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from flexflow_tpu_torch.ffconst import ActiMode, DataType, PoolType
from flexflow_tpu_torch.model import FFModel, Tensor


def _flatten_dims(ff: FFModel, x: Tensor, start: int, end: int,
                  name: Optional[str] = None) -> Tensor:
    """torch.flatten(x, start_dim, end_dim) semantics via reshape."""
    nd = len(x.shape)
    start, end = start % nd, end % nd
    if start == 1 and end == nd - 1:
        return ff.flat(x, name=name)
    shape = (list(x.shape[:start])
             + [int(np.prod(x.shape[start:end + 1]))]
             + list(x.shape[end + 1:]))
    return ff.reshape(x, shape, name=name)


def _rms_norm_class_name(mod) -> bool:
    cls = type(mod).__name__
    return cls.endswith("RMSNorm") or cls == "T5LayerNorm"


def _is_rms_norm_module(mod) -> bool:
    """RMSNorm-family detection by class name + shape of the module: a
    single 1-D `weight` parameter and a variance epsilon. Covers
    transformers' T5LayerNorm / LlamaRMSNorm / MistralRMSNorm / GemmaRMSNorm
    and torch.nn.RMSNorm without importing any of them. Reads _parameters
    directly — during fx tracing, attribute access on a module is patched
    to return Proxies, and Proxy.__bool__ raises."""
    if not _rms_norm_class_name(mod):
        return False
    params = getattr(mod, "_parameters", {})
    w = params.get("weight")
    return w is not None and getattr(w, "ndim", 0) == 1


def _rms_eps(mod) -> float:
    for attr in ("variance_epsilon", "eps"):
        v = getattr(mod, attr, None)
        if v is not None:  # 0.0 is a legitimate explicit eps
            return float(v)
    return 1e-6


def _act(ff: FFModel, t: Tensor, mod) -> Tensor:
    import torch.nn as nn

    table = {
        nn.ReLU: ff.relu,
        nn.GELU: ff.gelu,
        nn.Sigmoid: ff.sigmoid,
        nn.Tanh: ff.tanh,
        nn.SiLU: ff.silu,
        nn.ELU: ff.elu,
    }
    return table[type(mod)](t)


class PyTorchModel:
    """Wraps a torch.nn.Module; `torch_to_ff` replays its fx graph as
    FFModel layer calls and returns the output tensors."""

    def __init__(self, model, seq_length: Optional[int] = None):
        import torch.fx

        class _HFAwareTracer(torch.fx.Tracer):
            """HF-aware coalescing (reference torch/model.py:2408-2495
            special-cases T5LayerNorm / mt5): RMSNorm-family modules are
            kept as LEAF nodes so they lower to one RMS_NORM op instead of
            an exploded mean/rsqrt/mul subgraph whose weights can't be
            mapped back."""

            def is_leaf_module(self, m, qualname):
                if _is_rms_norm_module(m):
                    return True
                return super().is_leaf_module(m, qualname)

        self.model = model
        graph = _HFAwareTracer().trace(model)
        self.traced = torch.fx.GraphModule(model, graph)
        # module path -> ALL ff node names it lowered to (a module called at
        # several sites becomes several FF layers; copy_weights fills each).
        # Note: the copies are not tied for training — updates diverge.
        self._name_map: Dict[str, List[str]] = {}
        # nn.LSTM modules expand into one FF lstm per (layer, direction),
        # each needing its OWN weight slice: target -> [(ff_name, layer,
        # is_reverse)]
        self._rnn_map: Dict[str, List[tuple]] = {}

    # ------------------------------------------------------------------

    def torch_to_ff(self, ff: FFModel, input_tensors: Sequence[Tensor]) -> List[Tensor]:
        import operator

        import torch
        import torch.nn as nn
        import torch.nn.functional as F

        env: Dict[str, Union[Tensor, float, int, tuple]] = {}
        inputs = list(input_tensors)
        outputs: List[Tensor] = []

        def val(a):
            if isinstance(a, torch.fx.Node):
                return env[a.name]
            if isinstance(a, (list, tuple)):
                return type(a)(val(x) for x in a)
            return a

        for node in self.traced.graph.nodes:
            if node.op == "placeholder":
                env[node.name] = inputs.pop(0)
            elif node.op == "get_attr":
                # constants/buffers/parameters all become weights holding
                # their traced values
                import operator as _op

                from flexflow_tpu_torch.runtime.initializer import ArrayInitializer

                try:
                    t = self.traced.get_parameter(node.target)
                except AttributeError:
                    try:
                        t = self.traced.get_buffer(node.target)
                    except AttributeError:
                        t = _op.attrgetter(node.target)(self.traced)
                arr = t.detach().cpu().numpy()
                env[node.name] = ff.create_weight(
                    arr.shape, initializer=ArrayInitializer(arr), name=node.name
                )
            elif node.op == "call_module":
                mod = self.traced.get_submodule(node.target)
                x = val(node.args[0])
                env[node.name] = self._lower_module(ff, node, mod, x)
            elif node.op == "call_function":
                env[node.name] = self._lower_function(ff, node, val)
            elif node.op == "call_method":
                env[node.name] = self._lower_method(ff, node, val)
            elif node.op == "output":
                out = val(node.args[0])
                outputs = list(out) if isinstance(out, (list, tuple)) else [out]
        return outputs

    # ------------------------------------------------------------------

    def _record(self, target: str, t: Tensor) -> Tensor:
        # the layer call may have deduped the requested name; record the
        # final node name so copy_weights hits the right layer(s)
        self._name_map.setdefault(target, []).append(t.node.name)
        return t

    def _lower_module(self, ff: FFModel, node, mod, x: Tensor) -> Tensor:
        import torch.nn as nn

        name = node.target.replace(".", "_")
        if isinstance(mod, nn.Linear):
            return self._record(node.target, ff.dense(
                x, mod.out_features, use_bias=mod.bias is not None, name=name))
        if isinstance(mod, nn.Conv2d):
            return self._record(node.target, ff.conv2d(
                x, mod.out_channels, *mod.kernel_size,
                stride_h=mod.stride[0], stride_w=mod.stride[1],
                padding_h=mod.padding[0], padding_w=mod.padding[1],
                groups=mod.groups, use_bias=mod.bias is not None, name=name,
            ))
        if isinstance(mod, nn.Embedding):
            return self._record(node.target, ff.embedding(
                x, mod.num_embeddings, mod.embedding_dim, name=name))
        if isinstance(mod, nn.BatchNorm2d):
            return self._record(node.target, ff.batch_norm(x, relu=False, name=name))
        if isinstance(mod, nn.LayerNorm):
            return self._record(node.target, ff.layer_norm(
                x, axes=tuple(range(-len(mod.normalized_shape), 0)),
                elementwise_affine=mod.elementwise_affine,
                eps=mod.eps, name=name))
        if isinstance(mod, nn.MaxPool2d):
            k = mod.kernel_size if isinstance(mod.kernel_size, tuple) else (mod.kernel_size,) * 2
            s = mod.stride if isinstance(mod.stride, tuple) else (mod.stride,) * 2
            p = mod.padding if isinstance(mod.padding, tuple) else (mod.padding,) * 2
            return ff.pool2d(x, k[0], k[1], s[0], s[1], p[0], p[1], PoolType.MAX,
                             name=name)
        if isinstance(mod, nn.AvgPool2d):
            k = mod.kernel_size if isinstance(mod.kernel_size, tuple) else (mod.kernel_size,) * 2
            s = mod.stride if isinstance(mod.stride, tuple) else (mod.stride,) * 2
            p = mod.padding if isinstance(mod.padding, tuple) else (mod.padding,) * 2
            return ff.pool2d(x, k[0], k[1], s[0], s[1], p[0], p[1], PoolType.AVG,
                             name=name)
        if isinstance(mod, nn.AdaptiveAvgPool2d):
            out = mod.output_size if isinstance(mod.output_size, tuple) else (mod.output_size,) * 2
            h, w = x.shape[2], x.shape[3]
            if out == (1, 1):
                return ff.mean(x, axes=(2, 3), keepdims=True, name=name)
            kh, kw = h // out[0], w // out[1]
            return ff.pool2d(x, kh, kw, kh, kw, 0, 0, PoolType.AVG, name=name)
        if isinstance(mod, nn.Dropout):
            return ff.dropout(x, mod.p, name=name)
        if isinstance(mod, nn.Flatten):
            return _flatten_dims(ff, x, mod.start_dim, mod.end_dim, name=name)
        if isinstance(mod, nn.Softmax):
            return ff.softmax(x, axis=mod.dim if mod.dim is not None else -1, name=name)
        if isinstance(mod, nn.Identity):
            return ff.identity(x, name=name)
        if isinstance(mod, (nn.ReLU, nn.GELU, nn.Sigmoid, nn.Tanh, nn.SiLU, nn.ELU)):
            return _act(ff, x, mod)
        if _is_rms_norm_module(mod):
            return self._record(node.target,
                                ff.rms_norm(x, eps=_rms_eps(mod), name=name))
        if isinstance(mod, nn.LSTM):
            # expands into one FF lstm op per (layer, direction); returns
            # the torch-shaped (output, states) tuple so downstream getitem
            # nodes unpack it. The packed (layers*dirs, batch, hidden)
            # states have no faithful analog here, so consuming them raises
            # (see _TorchLSTMStates).
            if not mod.batch_first:
                raise NotImplementedError(
                    "nn.LSTM import requires batch_first=True (framework "
                    "layout is (batch, seq, dim))"
                )
            if getattr(mod, "proj_size", 0):
                raise NotImplementedError(
                    "nn.LSTM proj_size != 0 is not supported"
                )
            if len(node.args) > 1 or node.kwargs:
                raise NotImplementedError(
                    "nn.LSTM import with explicit initial states is not "
                    "supported (torch packs them (layers*dirs, batch, "
                    "hidden); build with FFModel.lstm(initial_state=...) "
                    "directly)"
                )
            t, entries = _build_lstm_stack(
                ff, x, mod.hidden_size, mod.num_layers, mod.bidirectional,
                float(mod.dropout), mod.bias, name,
            )
            self._rnn_map.setdefault(node.target, []).extend(entries)
            return (t, _TorchLSTMStates())
        if isinstance(mod, nn.Sequential):
            t = x
            for child_name, sub in mod.named_children():
                # qualify by the child's own module path so names stay unique
                # and copy_weights resolves the actual leaf module
                fake = type(
                    "N", (),
                    {"target": f"{node.target}.{child_name}",
                     "name": f"{node.name}_{child_name}"},
                )
                t = self._lower_module(ff, fake, sub, t)
            return t
        raise NotImplementedError(f"torch module {type(mod).__name__} not supported")

    def _lower_function(self, ff: FFModel, node, val):
        import operator

        import torch
        import torch.nn.functional as F

        fn = node.target
        a = [val(x) for x in node.args]
        if fn is operator.getitem:
            if not isinstance(a[0], Tensor):
                # unpacking a module's tuple return (e.g. nn.LSTM's
                # (output, states)) — or hitting a placeholder like
                # _TorchLSTMStates, whose __getitem__ raises its own
                # targeted message
                return a[0][a[1]]
            return self._lower_getitem(ff, a[0], a[1])
        if fn in (operator.add, torch.add):
            if isinstance(a[1], Tensor):
                return ff.add(a[0], a[1])
            return ff.scalar_add(a[0], float(a[1]))
        if fn in (operator.sub, torch.sub):
            if isinstance(a[1], Tensor):
                return ff.subtract(a[0], a[1])
            return ff.scalar_sub(a[0], float(a[1]))
        if fn in (operator.mul, torch.mul):
            if isinstance(a[1], Tensor):
                return ff.multiply(a[0], a[1])
            return ff.scalar_multiply(a[0], float(a[1]))
        if fn in (operator.truediv, torch.div):
            if isinstance(a[1], Tensor):
                return ff.divide(a[0], a[1])
            return ff.scalar_true_divide(a[0], float(a[1]))
        if fn in (torch.relu, F.relu):
            return ff.relu(a[0])
        if fn is F.gelu:
            return ff.gelu(a[0])
        if fn in (torch.sigmoid, F.sigmoid):
            return ff.sigmoid(a[0])
        if fn in (torch.tanh, F.tanh):
            return ff.tanh(a[0])
        if fn in (torch.flatten,):
            start = a[1] if len(a) > 1 else node.kwargs.get("start_dim", 0)
            end = a[2] if len(a) > 2 else node.kwargs.get("end_dim", -1)
            return _flatten_dims(ff, a[0], int(start), int(end))
        if fn in (torch.cat,):
            axis = node.kwargs.get("dim", 0)
            if len(node.args) > 1:
                axis = node.args[1]
            return ff.concat(a[0], axis=axis)
        if fn in (torch.matmul, torch.bmm):
            return ff.batch_matmul(a[0], a[1])
        if fn is F.softmax:
            return ff.softmax(a[0], axis=node.kwargs.get("dim", -1))
        if fn is torch.exp:
            return ff.exp(a[0])
        if fn is torch.pow:
            return ff.pow(a[0], float(a[1]))
        if fn is torch.rsqrt:
            return ff.rsqrt(a[0])
        if fn is torch.mean:
            dims = a[1] if len(a) > 1 else node.kwargs.get("dim")
            keep = node.kwargs.get("keepdim", False)
            return ff.mean(a[0], axes=tuple(dims) if isinstance(dims, (list, tuple)) else (dims,), keepdims=keep)
        if fn in (F.avg_pool2d, F.max_pool2d):
            from flexflow_tpu_torch.ffconst import PoolType

            ks = a[1] if len(a) > 1 else node.kwargs["kernel_size"]
            kh, kw = (ks, ks) if isinstance(ks, int) else tuple(ks)
            st = (a[2] if len(a) > 2 else None) or node.kwargs.get("stride") or ks
            sh, sw = (st, st) if isinstance(st, int) else tuple(st)
            pad = a[3] if len(a) > 3 else node.kwargs.get("padding", 0)
            ph, pw = (pad, pad) if isinstance(pad, int) else tuple(pad)
            pt = PoolType.AVG if fn is F.avg_pool2d else PoolType.MAX
            return ff.pool2d(a[0], kh, kw, sh, sw, ph, pw, pool_type=pt)
        if fn in (F.silu,):
            return ff.silu(a[0])
        if fn is F.dropout:
            rate = node.kwargs.get("p", a[1] if len(a) > 1 else 0.5)
            return ff.dropout(a[0], rate=float(rate))
        raise NotImplementedError(f"torch function {fn} not supported")

    def _lower_getitem(self, ff: FFModel, x: Tensor, idx):
        return _tensor_getitem(ff, x, idx)

    def _lower_method(self, ff: FFModel, node, val):
        a = [val(x) for x in node.args]
        m = node.target
        x = a[0]
        if m in ("view", "reshape"):
            shape = a[1:] if not isinstance(a[1], (list, tuple)) else list(a[1])
            shape = [int(s) for s in shape]
            total = int(np.prod(x.shape))
            known = int(np.prod([s for s in shape if s != -1]))
            shape = [total // known if s == -1 else s for s in shape]
            return ff.reshape(x, shape)
        if m == "flatten":
            start = a[1] if len(a) > 1 else node.kwargs.get("start_dim", 0)
            end = a[2] if len(a) > 2 else node.kwargs.get("end_dim", -1)
            return _flatten_dims(ff, x, int(start), int(end))
        if m == "transpose":
            d0, d1 = a[1], a[2]
            perm = list(range(len(x.shape)))
            perm[d0], perm[d1] = perm[d1], perm[d0]
            return ff.transpose(x, perm)
        if m == "permute":
            perm = a[1:] if not isinstance(a[1], (list, tuple)) else list(a[1])
            return ff.transpose(x, [int(p) for p in perm])
        if m == "contiguous":
            return x
        if m == "size":
            return x.shape[a[1]] if len(a) > 1 else x.shape
        raise NotImplementedError(f"torch method {m} not supported")

    # ------------------------------------------------------------------

    def copy_weights(self, ff: FFModel):
        """Push the torch module's weights into the compiled model (from
        torch tensors on any device)."""
        import torch.nn as nn

        for target, ff_names in self._name_map.items():
            mod = self.traced.get_submodule(target)
            for ff_name in ff_names:
                if isinstance(mod, nn.Linear):
                    ff.set_weight(ff_name, mod.weight.detach().T, "kernel")
                    if mod.bias is not None:
                        ff.set_weight(ff_name, mod.bias.detach(), "bias")
                elif isinstance(mod, nn.Conv2d):
                    ff.set_weight(ff_name, mod.weight.detach(), "kernel")
                    if mod.bias is not None:
                        ff.set_weight(ff_name, mod.bias.detach(), "bias")
                elif isinstance(mod, nn.Embedding):
                    ff.set_weight(ff_name, mod.weight.detach(), "kernel")
                elif isinstance(mod, nn.LayerNorm):
                    ff.set_weight(ff_name, mod.weight.detach(), "scale")
                    ff.set_weight(ff_name, mod.bias.detach(), "bias")
                elif isinstance(mod, nn.BatchNorm2d):
                    ff.set_weight(ff_name, mod.weight.detach(), "scale")
                    ff.set_weight(ff_name, mod.bias.detach(), "bias")
                    ff.set_weight(ff_name, mod.running_mean.detach(),
                                  "running_mean")
                    ff.set_weight(ff_name, mod.running_var.detach(),
                                  "running_var")
                elif _is_rms_norm_module(mod):
                    w = mod.weight.detach()
                    # Gemma's RMSNorm scales by (1 + weight); our RMS_NORM
                    # scales by the stored weight, so fold the +1 in
                    if type(mod).__name__.startswith("Gemma"):
                        w = w + 1.0
                    ff.set_weight(ff_name, w, "scale")
        for target, entries in self._rnn_map.items():
            mod = self.traced.get_submodule(target)
            for ff_name, layer, rev in entries:
                sfx = f"l{layer}" + ("_reverse" if rev else "")
                ff.set_weight(
                    ff_name,
                    getattr(mod, f"weight_ih_{sfx}").detach().T, "wx")
                ff.set_weight(
                    ff_name,
                    getattr(mod, f"weight_hh_{sfx}").detach().T, "wh")
                if mod.bias:
                    b = (getattr(mod, f"bias_ih_{sfx}")
                         + getattr(mod, f"bias_hh_{sfx}")).detach()
                    ff.set_weight(ff_name, b, "bias")

    # ------------------------------------------------------------------
    # text IR (reference torch_to_file/file_to_ff, torch/model.py:2597,2540)

    def torch_to_file(self, path: str):
        """Serialize the fx graph to a text IR, from which file_to_ff
        rebuilds the graph without the module's code."""
        import torch

        lines = []
        for node in self.traced.graph.nodes:
            if node.op == "placeholder":
                lines.append(f"input\t{node.name}")
            elif node.op == "output":
                srcs = node.args[0]
                if not isinstance(srcs, (list, tuple)):
                    srcs = [srcs]
                lines.append("output\t" + ",".join(s.name for s in srcs))
            elif node.op == "call_module":
                mod = self.traced.get_submodule(node.target)
                spec = _module_spec(mod)
                if len(node.args) > 1 or node.kwargs:
                    # the IR records one input per module line; extra call
                    # args (e.g. nn.LSTM initial states) would be silently
                    # dropped and the rebuilt model would diverge
                    raise NotImplementedError(
                        f"text-IR: module {node.target} called with extra "
                        "args/kwargs; only single-input module calls export"
                    )
                args = ",".join(a.name for a in node.args
                                if isinstance(a, torch.fx.Node))
                lines.append(f"module\t{node.name}\t{args}\t{spec}")
            elif node.op in ("call_function", "call_method"):
                import operator

                fname = getattr(node.target, "__name__", str(node.target))
                args = []
                for a in node.args:
                    args.append(a.name if isinstance(a, torch.fx.Node) else repr(a))
                lines.append(f"{node.op}\t{node.name}\t{fname}\t{';'.join(args)}")
        with open(path, "w") as f:
            f.write("\n".join(lines))


class _TorchLSTMStates:
    """Placeholder for nn.LSTM's (h_n, c_n) return slot: torch packs states
    as (num_layers*num_directions, batch, hidden), which the
    per-(layer, direction) expansion cannot reproduce faithfully — so a
    model that actually CONSUMES them fails loudly here instead of
    computing silently wrong results. (`y, _ = self.lstm(x)` binds but
    never touches this and imports fine.)"""

    def _unsupported(self):
        raise NotImplementedError(
            "nn.LSTM import: consuming h_n/c_n is not supported (torch "
            "packs them (layers*dirs, batch, hidden)); read the sequence "
            "output instead, or build with FFModel.lstm directly"
        )

    def __getitem__(self, i):
        self._unsupported()

    def __iter__(self):
        self._unsupported()


def _build_lstm_stack(ff: FFModel, x: Tensor, hidden: int, layers: int,
                      bidir: bool, dropout: float, use_bias: bool,
                      name: str):
    """Shared stacked/bidirectional nn.LSTM expansion (fx import + text-IR
    replay): one FF lstm per (layer, direction), directions concatenated on
    the feature dim, inter-layer dropout. Returns (output, entries) where
    entries = [(ff_node_name, layer, is_reverse)] for weight copy."""
    t, entries = x, []
    for layer in range(layers):
        y, _, _ = ff.lstm(t, hidden, use_bias=use_bias,
                          name=f"{name}_l{layer}")
        entries.append((y.node.name, layer, False))
        if bidir:
            yr, _, _ = ff.lstm(t, hidden, use_bias=use_bias, reverse=True,
                               name=f"{name}_l{layer}_rev")
            entries.append((yr.node.name, layer, True))
            y = ff.concat([y, yr], axis=-1, name=f"{name}_l{layer}_cat")
        t = y
        if dropout and layer < layers - 1:
            t = ff.dropout(t, dropout, name=f"{name}_l{layer}_do")
    return t, entries


def _tensor_getitem(ff: FFModel, x: Tensor, idx):
    """Basic tensor indexing (`y[:, -1]`, `y[..., :h]`): each indexed dim
    becomes a split that keeps the addressed piece; int indices squeeze
    their dim afterwards. Step slices / advanced indexing unsupported."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(it is Ellipsis for it in idx):
        # expand `...` to full slices over the unindexed middle dims
        pos = idx.index(Ellipsis)
        fill = len(x.shape) - (len(idx) - 1)
        idx = idx[:pos] + (slice(None),) * fill + idx[pos + 1:]
    t, squeeze = x, []
    for dim, it in enumerate(idx):
        size = t.shape[dim]
        if isinstance(it, slice):
            if it == slice(None):
                continue
            if it.step not in (None, 1):
                raise NotImplementedError(f"step slice {it} not supported")
            start, stop, _ = it.indices(size)
            if stop <= start:
                raise NotImplementedError(f"empty slice {it}")
            keep_start, keep_len = start, stop - start
        elif isinstance(it, int):
            if not -size <= it < size:
                raise IndexError(
                    f"index {it} out of range for dim {dim} of size {size}"
                )
            keep_start, keep_len = it % size, 1
            squeeze.append(dim)
        else:
            raise NotImplementedError(f"index {it!r} not supported")
        sizes = [keep_start, keep_len, size - keep_start - keep_len]
        keep_pos = int(keep_start > 0)  # a leading piece shifts the kept one
        pieces = ff.split(t, [s for s in sizes if s > 0], axis=dim)
        t = pieces[keep_pos] if isinstance(pieces, list) else pieces
    if squeeze:
        shape = [s for d, s in enumerate(t.shape) if d not in squeeze]
        t = ff.reshape(t, shape)
    return t


def _parse_index(s: str):
    """Parse a getitem index serialized by repr() back into ints/slices/
    tuples/Ellipsis — WITHOUT eval (IR files are untrusted input)."""
    import ast

    def conv(n):
        if isinstance(n, ast.Tuple):
            return tuple(conv(e) for e in n.elts)
        if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "slice":
            return slice(*(conv(a) for a in n.args))
        if isinstance(n, ast.Constant):
            return n.value
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -conv(n.operand)
        if isinstance(n, ast.Name) and n.id == "Ellipsis":
            return Ellipsis
        raise NotImplementedError(f"text-IR index {s!r}")

    return conv(ast.parse(s, mode="eval").body)


def _module_spec(mod) -> str:
    import torch.nn as nn

    if isinstance(mod, nn.Linear):
        return f"Linear:{mod.in_features}:{mod.out_features}:{int(mod.bias is not None)}"
    if isinstance(mod, nn.Conv2d):
        return (f"Conv2d:{mod.out_channels}:{mod.kernel_size[0]}:{mod.kernel_size[1]}"
                f":{mod.stride[0]}:{mod.stride[1]}:{mod.padding[0]}:{mod.padding[1]}"
                f":{mod.groups}:{int(mod.bias is not None)}")
    if isinstance(mod, nn.ReLU):
        return "ReLU"
    if isinstance(mod, nn.GELU):
        return "GELU"
    if isinstance(mod, nn.MaxPool2d):
        k = mod.kernel_size if isinstance(mod.kernel_size, tuple) else (mod.kernel_size,) * 2
        s = mod.stride if isinstance(mod.stride, tuple) else (mod.stride,) * 2
        p = mod.padding if isinstance(mod.padding, tuple) else (mod.padding,) * 2
        return f"MaxPool2d:{k[0]}:{k[1]}:{s[0]}:{s[1]}:{p[0]}:{p[1]}"
    if isinstance(mod, nn.Flatten):
        return "Flatten"
    if isinstance(mod, nn.Dropout):
        return f"Dropout:{mod.p}"
    if isinstance(mod, nn.Softmax):
        return f"Softmax:{mod.dim if mod.dim is not None else -1}"
    if isinstance(mod, nn.LayerNorm):
        return f"LayerNorm:{len(mod.normalized_shape)}:{mod.eps}"
    if isinstance(mod, nn.Embedding):
        return f"Embedding:{mod.num_embeddings}:{mod.embedding_dim}"
    if isinstance(mod, nn.BatchNorm2d):
        return "BatchNorm2d"
    if _is_rms_norm_module(mod):
        return f"RMSNorm:{_rms_eps(mod)}"
    if isinstance(mod, nn.LSTM):
        if not mod.batch_first:
            raise NotImplementedError("text-IR LSTM requires batch_first=True")
        if getattr(mod, "proj_size", 0):
            raise NotImplementedError("text-IR LSTM proj_size != 0 unsupported")
        return (f"LSTM:{mod.hidden_size}:{mod.num_layers}"
                f":{int(mod.bidirectional)}:{mod.dropout}:{int(mod.bias)}")
    raise NotImplementedError(f"no text-IR spec for {type(mod).__name__}")


def file_to_ff(path: str, ff: FFModel, input_tensors: Sequence[Tensor]) -> List[Tensor]:
    """Rebuild an FFModel graph from the text IR."""
    env: Dict[str, Tensor] = {}
    inputs = list(input_tensors)
    outputs: List[Tensor] = []
    with open(path) as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            parts = line.split("\t")
            kind = parts[0]
            if kind == "input":
                env[parts[1]] = inputs.pop(0)
            elif kind == "output":
                outputs = [env[n] for n in parts[1].split(",")]
            elif kind == "module":
                name, args, spec = parts[1], parts[2], parts[3]
                x = env[args.split(",")[0]]
                env[name] = _apply_spec(ff, spec, x, name)
            elif kind in ("call_function", "call_method"):
                import ast

                name, fname, rawargs = parts[1], parts[2], parts[3]
                args = rawargs.split(";")
                ts = [env[a] for a in args if a in env]

                def scalars():
                    # scalar operand may come before or after the tensor;
                    # parse with literal_eval (never eval untrusted IR
                    # files). Lazy: getitem's slice reprs aren't literals.
                    return [ast.literal_eval(a) for a in args if a not in env]
                if fname == "add":
                    env[name] = (ff.add(ts[0], ts[1]) if len(ts) > 1
                                 else ff.scalar_add(ts[0], float(scalars()[0])))
                elif fname == "mul":
                    env[name] = (ff.multiply(ts[0], ts[1]) if len(ts) > 1
                                 else ff.scalar_multiply(ts[0], float(scalars()[0])))
                elif fname == "flatten":
                    env[name] = ff.flat(ts[0])
                elif fname == "relu":
                    env[name] = ff.relu(ts[0])
                elif fname == "getitem":
                    v = ts[0]
                    # the index is the SECOND arg (repr-serialized)
                    sub = _parse_index(args[1])
                    if isinstance(v, Tensor):
                        env[name] = _tensor_getitem(ff, v, sub)
                    else:
                        # tuple returns / placeholders index themselves
                        env[name] = v[sub]
                else:
                    raise NotImplementedError(f"text-IR function {fname}")
    return outputs


def _apply_spec(ff: FFModel, spec: str, x: Tensor, name: str) -> Tensor:
    parts = spec.split(":")
    kind = parts[0]
    if kind == "Linear":
        return ff.dense(x, int(parts[2]), use_bias=bool(int(parts[3])), name=name)
    if kind == "Conv2d":
        o, kh, kw, sh, sw, ph, pw, g, b = (int(p) for p in parts[1:])
        return ff.conv2d(x, o, kh, kw, sh, sw, ph, pw, groups=g,
                         use_bias=bool(b), name=name)
    if kind == "ReLU":
        return ff.relu(x, name=name)
    if kind == "GELU":
        return ff.gelu(x, name=name)
    if kind == "MaxPool2d":
        vals = [int(p) for p in parts[1:]]
        kh, kw, sh, sw = vals[:4]
        ph, pw = vals[4:6] if len(vals) >= 6 else (0, 0)
        return ff.pool2d(x, kh, kw, sh, sw, ph, pw, name=name)
    if kind == "Flatten":
        return ff.flat(x, name=name)
    if kind == "Dropout":
        return ff.dropout(x, float(parts[1]), name=name)
    if kind == "Softmax":
        return ff.softmax(x, axis=int(parts[1]), name=name)
    if kind == "LayerNorm":
        return ff.layer_norm(x, axes=tuple(range(-int(parts[1]), 0)),
                             eps=float(parts[2]), name=name)
    if kind == "Embedding":
        return ff.embedding(x, int(parts[1]), int(parts[2]), name=name)
    if kind == "BatchNorm2d":
        return ff.batch_norm(x, relu=False, name=name)
    if kind == "RMSNorm":
        return ff.rms_norm(x, eps=float(parts[1]), name=name)
    if kind == "LSTM":
        hidden, layers, bidir, drop, bias = (
            int(parts[1]), int(parts[2]), bool(int(parts[3])),
            float(parts[4]), bool(int(parts[5])),
        )
        t, _ = _build_lstm_stack(ff, x, hidden, layers, bidir, drop, bias,
                                 name)
        return (t, _TorchLSTMStates())
    raise NotImplementedError(f"text-IR spec {kind}")
