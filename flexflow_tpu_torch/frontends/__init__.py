"""Frontends (counterpart of flexflow_tpu/frontends/): import models into
the FFModel layer graph from HuggingFace causal LMs (hf), torch.fx traces
(torch_fx), a Keras-style API (keras) and tf.keras JSON (keras_exp). The
ONNX frontend waits for the onnx package (ROADMAP.md, queue 1 item 10)."""
