"""ONNX export without the `onnx` package (the port's counterpart of
`tpu_yolo/utils/onnx/`).

export.py converts the `torch.export` graph of the BN-folded f32 eval
forward node by node into a stock opset-17 graph, written by its own
protobuf writer (wire.py). parse.py reads the bytes back and interp.py
runs the parsed graph in numpy (Conv and MaxPool through torch on the
CPU), so a file is checked bytes -> parse -> run against the live
forward without `onnx` or `onnxruntime`; where they exist, the same
file loads there directly.
"""
from tpu_yolo_torch.utils.onnx.export import export_onnx  # noqa: F401
