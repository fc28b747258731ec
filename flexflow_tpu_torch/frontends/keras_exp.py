"""keras_exp — tf.keras graph-walking frontend (counterpart of
flexflow_tpu/frontends/keras_exp.py).

Reference analog: python/flexflow/keras_exp/models/model.py (~600 LoC) —
the variant that walks a REAL tf.keras model's graph instead of
re-implementing the keras API (which frontends/keras does).

Design: the walker consumes the standard `model.to_json()` functional
config (Keras 3 format: per-layer `inbound_nodes` carrying
`__keras_tensor__.keras_history = [producer, node_idx, tensor_idx]`), so
importing a model needs no tensorflow at all: hand the JSON produced
elsewhere to `KerasExpModel(json_config=...)`. With a live tf.keras model,
`KerasExpModel(model)` walks the same config and `copy_weights` pushes the
trained tf weights into the compiled FFModel.

Layout note: Conv/Pool layers must be `channels_first` (the PCG is NCHW,
like the reference); channels_last models raise with a clear message.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.ffconst import ActiMode, PoolType
from flexflow_tpu_torch.model import FFModel, Tensor

_ACT = {
    "linear": ActiMode.NONE,
    "relu": ActiMode.RELU,
    "gelu": ActiMode.GELU,
    "sigmoid": ActiMode.SIGMOID,
    "tanh": ActiMode.TANH,
    "silu": ActiMode.SILU,
    "swish": ActiMode.SILU,
}


def _histories(obj) -> List[Tuple[str, int, int]]:
    """Collect keras_history refs from an inbound-node args tree in order."""
    out = []
    if isinstance(obj, dict):
        if obj.get("class_name") == "__keras_tensor__":
            h = obj["config"]["keras_history"]
            out.append((h[0], h[1], h[2]))
        else:
            for v in obj.values():
                out.extend(_histories(v))
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out.extend(_histories(v))
    return out


def _norm_refs(entry) -> List[List]:
    """input_layers/output_layers come as [name, n, t] or [[name, n, t]...]."""
    if entry and isinstance(entry[0], str):
        return [entry]
    return list(entry)


class KerasExpModel:
    """Walks a tf.keras functional/sequential model (or its to_json()
    string) into FFModel layer calls."""

    def __init__(self, model=None, json_config: Optional[str] = None):
        if model is None and json_config is None:
            raise ValueError("pass a tf.keras model or a to_json() string")
        self.model = model
        if json_config is None:
            json_config = model.to_json()
        cfg = json.loads(json_config)
        if cfg.get("class_name") == "Sequential":
            cfg = self._sequential_to_functional(cfg)
        self.config = cfg["config"]
        self._names: List[str] = []  # ff layer names we created (weighted)

    @staticmethod
    def _sequential_to_functional(cfg: Dict) -> Dict:
        """Rewrite a Sequential config into functional form (each layer
        feeds the next). Keras 3 Sequentials built without an explicit
        Input often serialize with NO InputLayer entry — synthesize one so
        the first real layer is lowered instead of aliased to the input."""
        layers = list(cfg["config"]["layers"])
        if not layers or layers[0]["class_name"] != "InputLayer":
            layers.insert(0, {"class_name": "InputLayer",
                              "name": "_seq_input",
                              "config": {"name": "_seq_input"}})
        out = []
        prev = None
        for entry in layers:
            e = dict(entry)
            name = e.get("config", {}).get("name") or e.get("name")
            e["name"] = name
            if prev is None:
                e["inbound_nodes"] = []
            else:
                e["inbound_nodes"] = [{
                    "args": [{
                        "class_name": "__keras_tensor__",
                        "config": {"keras_history": [prev, 0, 0]},
                    }],
                }]
            out.append(e)
            prev = name
        first, last = out[0]["name"], out[-1]["name"]
        return {"config": {"layers": out,
                           "input_layers": [first, 0, 0],
                           "output_layers": [last, 0, 0]}}

    # ------------------------------------------------------------------

    def to_ff(self, ff: FFModel, input_tensors: Sequence[Tensor]) -> List[Tensor]:
        layers = {e.get("name") or e["config"]["name"]: e
                  for e in self.config["layers"]}
        inputs = _norm_refs(self.config["input_layers"])
        outputs = _norm_refs(self.config["output_layers"])
        if len(inputs) != len(input_tensors):
            raise ValueError(
                f"model has {len(inputs)} inputs, got {len(input_tensors)}"
            )
        env: Dict[str, Tensor] = {}
        for (name, _, _), t in zip(inputs, input_tensors):
            env[name] = t

        # topo walk: keras configs list layers in build order
        for entry in self.config["layers"]:
            name = entry.get("name") or entry["config"]["name"]
            if name in env:
                continue
            refs = _histories(entry.get("inbound_nodes", []))
            ins = [env[r[0]] for r in refs]
            env[name] = self._lower(ff, entry["class_name"],
                                    entry["config"], name, ins)
        return [env[name] for (name, _, _) in outputs]

    def _lower(self, ff: FFModel, cls: str, cfg: Dict, name: str,
               ins: List[Tensor]) -> Tensor:
        def act_of(key="activation"):
            a = cfg.get(key) or "linear"
            if isinstance(a, dict):  # serialized Activation object
                a = a.get("config", {}).get("name", "linear")
            if a == "softmax":
                return "softmax"
            if a not in _ACT:
                raise NotImplementedError(f"keras activation {a!r}")
            return _ACT[a]

        if cls == "Dense":
            act = act_of()
            if act == "softmax":
                t = ff.dense(ins[0], cfg["units"],
                             use_bias=cfg.get("use_bias", True), name=name)
                self._names.append(name)
                return ff.softmax(t, name=f"{name}_softmax")
            t = ff.dense(ins[0], cfg["units"], act,
                         use_bias=cfg.get("use_bias", True), name=name)
            self._names.append(name)
            return t
        if cls == "Conv2D":
            if cfg.get("data_format") != "channels_first":
                raise NotImplementedError(
                    "keras_exp lowers NCHW graphs; build the tf model with "
                    "data_format='channels_first' (the PCG is NCHW like the "
                    "reference)"
                )
            kh, kw = cfg["kernel_size"]
            sh, sw = cfg["strides"]
            pad = cfg.get("padding", "valid")
            ph, pw = (kh // 2, kw // 2) if pad == "same" else (0, 0)
            act = act_of()
            if act == "softmax":
                raise NotImplementedError(
                    "Conv2D(activation='softmax') is not lowered"
                )
            t = ff.conv2d(ins[0], cfg["filters"], kh, kw, sh, sw, ph, pw,
                          use_bias=cfg.get("use_bias", True),
                          activation=act, name=name)
            self._names.append(name)
            return t
        if cls in ("MaxPooling2D", "AveragePooling2D"):
            if cfg.get("data_format") != "channels_first":
                raise NotImplementedError("pooling must be channels_first")
            kh, kw = cfg["pool_size"]
            sh, sw = cfg["strides"] or (kh, kw)
            pad = cfg.get("padding", "valid")
            ph, pw = (kh // 2, kw // 2) if pad == "same" else (0, 0)
            pt = PoolType.MAX if cls == "MaxPooling2D" else PoolType.AVG
            return ff.pool2d(ins[0], kh, kw, sh, sw, ph, pw, pt, name=name)
        if cls == "GlobalAveragePooling2D":
            return ff.mean(ins[0], axes=(2, 3), name=name)
        if cls == "Flatten":
            return ff.flat(ins[0], name=name)
        if cls == "Dropout":
            return ff.dropout(ins[0], cfg["rate"], name=name)
        if cls == "Activation":
            a = act_of("activation")
            if a == "softmax":
                return ff.softmax(ins[0], name=name)
            if a == ActiMode.NONE:
                return ff.identity(ins[0], name=name)
            fn = {ActiMode.RELU: ff.relu, ActiMode.GELU: ff.gelu,
                  ActiMode.SIGMOID: ff.sigmoid, ActiMode.TANH: ff.tanh,
                  ActiMode.SILU: ff.silu}[a]
            return fn(ins[0], name=name)
        if cls == "ReLU":
            return ff.relu(ins[0], name=name)
        if cls == "Softmax":
            return ff.softmax(ins[0], axis=cfg.get("axis", -1), name=name)
        if cls == "Add":
            t = ins[0]
            for i, o in enumerate(ins[1:]):
                t = ff.add(t, o, name=f"{name}_{i}" if len(ins) > 2 else name)
            return t
        if cls == "Multiply":
            t = ins[0]
            for i, o in enumerate(ins[1:]):
                t = ff.multiply(t, o,
                                name=f"{name}_{i}" if len(ins) > 2 else name)
            return t
        if cls == "Concatenate":
            return ff.concat(ins, axis=cfg.get("axis", -1), name=name)
        if cls == "Embedding":
            t = ff.embedding(ins[0], cfg["input_dim"], cfg["output_dim"],
                             name=name)
            self._names.append(name)
            return t
        if cls == "BatchNormalization":
            t = ff.batch_norm(ins[0], relu=False, name=name)
            self._names.append(name)
            return t
        if cls == "LayerNormalization":
            t = ff.layer_norm(ins[0], axes=(-1,),
                              eps=cfg.get("epsilon", 1e-3), name=name)
            self._names.append(name)
            return t
        raise NotImplementedError(f"keras layer {cls} not supported")

    # ------------------------------------------------------------------

    def copy_weights(self, ff: FFModel) -> None:
        """Push the live tf model's trained weights into the compiled
        FFModel (requires construction from a model, not bare JSON)."""
        if self.model is None:
            raise ValueError("copy_weights needs the live tf.keras model")
        for name in self._names:
            layer = self.model.get_layer(name)
            ws = layer.get_weights()
            cls = type(layer).__name__
            if cls == "Dense":
                ff.set_weight(name, ws[0], "kernel")  # (in, out) matches
                if len(ws) > 1:
                    ff.set_weight(name, ws[1], "bias")
            elif cls == "Conv2D":
                # keras HWIO -> our OIHW
                ff.set_weight(name, ws[0].transpose(3, 2, 0, 1), "kernel")
                if len(ws) > 1:
                    ff.set_weight(name, ws[1], "bias")
            elif cls == "Embedding":
                ff.set_weight(name, ws[0], "kernel")
            elif cls == "BatchNormalization":
                gamma, beta, mean, var = ws
                ff.set_weight(name, gamma, "scale")
                ff.set_weight(name, beta, "bias")
                ff.set_weight(name, mean, "running_mean")
                ff.set_weight(name, var, "running_var")
            elif cls == "LayerNormalization":
                # get_weights() content depends on scale/center flags:
                # [gamma, beta], [gamma], [beta], or []
                lcfg = layer.get_config()
                idx = 0
                if lcfg.get("scale", True):
                    ff.set_weight(name, ws[idx], "scale")
                    idx += 1
                if lcfg.get("center", True):
                    ff.set_weight(name, ws[idx], "bias")
