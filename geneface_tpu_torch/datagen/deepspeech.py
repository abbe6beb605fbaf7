"""DeepSpeech v0.1.0 from its frozen graph (port of
``geneface_tpu/datagen/deepspeech.py``).

The reference runs the TF1 frozen graph ``deepspeech-0_1_0-b90017e8.pb``
in TensorFlow (``data_util/deepspeech_features/deepspeech_features.py:
99-127``). Here, as in the JAX package, nothing of TensorFlow is needed:

- :func:`read_frozen_graph_consts` parses the ``.pb`` with a minimal
  protobuf wire-format reader (GraphDef → NodeDef → AttrValue →
  TensorProto; only ``Const`` payloads are materialized), a copy of the
  JAX package's. Its arrays come from ``np.frombuffer`` and are read-only:
  :func:`~geneface_tpu_torch.convert.deepspeech_state_dict` copies them.
- :func:`map_deepspeech_params` maps the consts onto the architecture, by
  name when recognizable, else by shape and serialization order (a copy).
- :class:`DeepSpeechNet` is the forward: 3 dense layers with ReLU clipped
  at 20 (494 → 2048 → 2048 → 2048), one unidirectional ``BasicLSTMCell``
  (2048; TF's gate order ``i, j, f, o``, forget bias +1.0, one bias), a
  clipped dense layer and the 29-way head. The JAX ``lax.scan`` is a loop
  over the frames here, each step one product of ``[x_t, h_{t-1}]`` with
  the whole ``[in + cell, 4·cell]`` kernel, as the JAX step computes it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

__all__ = [
    "read_frozen_graph_consts",
    "map_deepspeech_params",
    "DeepSpeechNet",
    "load_deepspeech",
    "deepspeech_logits",
]

# --------------------------------------------------------------------------
# minimal protobuf wire-format reader (GraphDef subset)
# --------------------------------------------------------------------------

_DT_NUMPY = {
    1: np.float32,   # DT_FLOAT
    2: np.float64,   # DT_DOUBLE
    3: np.int32,     # DT_INT32
    9: np.int64,     # DT_INT64
}


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.
    Length-delimited values come back as bytes; varints as int;
    fixed32/fixed64 as raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val, pos = buf[pos : pos + 8], pos + 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wt == 5:
            val, pos = buf[pos : pos + 4], pos + 4
        else:  # groups (3/4) never appear in GraphDef
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_tensor(buf: bytes) -> np.ndarray | None:
    """TensorProto → ndarray (dtype=1, tensor_shape=2, tensor_content=4,
    float_val=5, double_val=6, int_val=7, int64_val=10)."""
    dtype = 1
    shape: list[int] = []
    content = b""
    scalars: list = []
    for field, wt, val in _fields(buf):
        if field == 1 and wt == 0:
            dtype = val
        elif field == 2 and wt == 2:  # TensorShapeProto{ repeated dim=2 {size=1} }
            for f2, w2, v2 in _fields(val):
                if f2 == 2 and w2 == 2:
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 0:
                            shape.append(v3)
        elif field == 4 and wt == 2:
            content = val
        elif field == 5:  # float_val (packed or not)
            if wt == 5:
                scalars.append(struct.unpack("<f", val)[0])
            elif wt == 2:
                scalars.extend(np.frombuffer(val, "<f4").tolist())
        elif field == 6:
            if wt == 1:
                scalars.append(struct.unpack("<d", val)[0])
            elif wt == 2:
                scalars.extend(np.frombuffer(val, "<f8").tolist())
        elif field in (7, 10):  # int_val / int64_val varints
            if wt == 0:
                scalars.append(val)
            elif wt == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    scalars.append(v)
    np_dtype = _DT_NUMPY.get(dtype)
    if np_dtype is None:
        return None
    if content:
        arr = np.frombuffer(content, np_dtype)
    elif scalars:
        arr = np.asarray(scalars, np_dtype)
        if shape and arr.size == 1:  # proto scalar broadcast
            arr = np.full(int(np.prod(shape)), arr[0], np_dtype)
    else:
        arr = np.zeros(int(np.prod(shape)) if shape else 0, np_dtype)
    return arr.reshape(shape) if shape else arr


def read_frozen_graph_consts(path_or_bytes) -> list[tuple[str, np.ndarray]]:
    """GraphDef bytes/path → ``[(node_name, array), ...]`` for every Const
    node, in serialization order (= creation order for frozen graphs)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    consts = []
    for field, wt, node in _fields(data):
        if field != 1 or wt != 2:  # GraphDef.node
            continue
        name = op = ""
        tensor = None
        for f2, w2, v2 in _fields(node):
            if f2 == 1 and w2 == 2:
                name = v2.decode("utf-8", "replace")
            elif f2 == 2 and w2 == 2:
                op = v2.decode("utf-8", "replace")
            elif f2 == 5 and w2 == 2:  # attr map entry {1: key, 2: AttrValue}
                key = None
                attr = b""
                for f3, w3, v3 in _fields(v2):
                    if f3 == 1 and w3 == 2:
                        key = v3.decode("utf-8", "replace")
                    elif f3 == 2 and w3 == 2:
                        attr = v3
                if key == "value":
                    for f4, w4, v4 in _fields(attr):
                        if f4 == 8 and w4 == 2:  # AttrValue.tensor
                            tensor = _parse_tensor(v4)
        if op == "Const" and tensor is not None:
            consts.append((name, tensor))
    return consts


# --------------------------------------------------------------------------
# architecture mapping + forward
# --------------------------------------------------------------------------


class DeepSpeechNet(nn.Module):
    """DeepSpeech v0.1.0's acoustic model: ``h1..h3`` and ``h5`` clipped-ReLU
    dense layers (``nn.Linear``, weight = the TF kernel transposed), the
    LSTM's TF kernel ``lstm_kernel [in + cell, 4·cell]`` and ``lstm_bias``
    as they are in the graph, and the linear head ``h6``. ``relu_clip`` is
    Mozilla's 20."""

    def __init__(self, n_input: int = 494, n_hidden: int = 2048, n_cell: int = 2048,
                 n_classes: int = 29, relu_clip: float = 20.0):
        super().__init__()
        self.relu_clip = relu_clip
        self.h1 = nn.Linear(n_input, n_hidden)
        self.h2 = nn.Linear(n_hidden, n_hidden)
        self.h3 = nn.Linear(n_hidden, n_hidden)
        self.lstm_kernel = nn.Parameter(torch.zeros(n_hidden + n_cell, 4 * n_cell))
        self.lstm_bias = nn.Parameter(torch.zeros(4 * n_cell))
        self.h5 = nn.Linear(n_cell, n_hidden)
        self.h6 = nn.Linear(n_hidden, n_classes)

    def _dense_clip(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.relu(layer(h)), 0.0, self.relu_clip)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [T, n_input]`` MFCC context windows → logits ``[T, n_classes]``."""
        with record_function("gf::deepspeech"):
            h = self._dense_clip(self.h1, x)
            h = self._dense_clip(self.h2, h)
            h = self._dense_clip(self.h3, h)
            kernel, bias = self.lstm_kernel, self.lstm_bias
            cell = kernel.shape[1] // 4
            c = h.new_zeros(cell)
            hprev = h.new_zeros(cell)
            hs = []
            with record_function("gf::deepspeech_lstm"):
                for xt in h:
                    z = torch.cat([xt, hprev]) @ kernel + bias
                    i, j, f, o = torch.split(z, cell)
                    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
                    hprev = torch.sigmoid(o) * torch.tanh(c)
                    hs.append(hprev)
            h = self._dense_clip(self.h5, torch.stack(hs) if hs else h.new_zeros(0, cell))
            return self.h6(h)


def map_deepspeech_params(
    consts: list[tuple[str, np.ndarray]],
) -> dict[str, np.ndarray]:
    """Const list → DeepSpeechNet params, by name when recognizable, else by
    shape + serialization order (see module docstring)."""
    slots = ("h1", "b1", "h2", "b2", "h3", "b3",
             "lstm_kernel", "lstm_bias", "h5", "b5", "h6", "b6")
    params: dict[str, np.ndarray] = {}

    def last_token(name: str) -> str:
        return name.rsplit("/", 1)[-1].lower()

    for name, arr in consts:
        tok = last_token(name)
        if tok in ("h1", "b1", "h2", "b2", "h3", "b3", "h5", "b5", "h6", "b6"):
            params[tok] = arr
        elif "lstm" in name.lower() and tok in ("kernel", "weights", "w"):
            params["lstm_kernel"] = arr
        elif "lstm" in name.lower() and tok in ("bias", "b"):
            params["lstm_bias"] = arr
    if all(k in params for k in slots):
        return {k: params[k] for k in slots}

    # shape/order fallback: find the LSTM pair first ([in+cell, 4*cell] with
    # matching [4*cell] bias), then assign dense kernel/bias pairs in order.
    params = {}
    mats = [(n, a) for n, a in consts if a.ndim == 2 and a.dtype == np.float32]
    vecs = [(n, a) for n, a in consts if a.ndim == 1 and a.dtype == np.float32]
    lstm_i = None
    for i, (_, a) in enumerate(mats):
        if a.shape[1] % 4 == 0 and a.shape[0] > a.shape[1] // 4 >= 1:
            cell = a.shape[1] // 4
            if a.shape[1] == 4 * cell and any(
                v.shape == (4 * cell,) for _, v in vecs
            ) and a.shape[0] != a.shape[1]:
                # plausible [in+cell, 4*cell]; for DeepSpeech in==cell so
                # rows == 2*cell
                if a.shape[0] == 2 * cell:
                    lstm_i = i
                    break
    if lstm_i is None:
        raise ValueError(
            "could not locate the LSTM kernel among frozen-graph consts; "
            f"shapes = {[a.shape for _, a in mats]}"
        )
    lk = mats[lstm_i][1]
    cell = lk.shape[1] // 4
    params["lstm_kernel"] = lk
    lb = next(v for _, v in vecs if v.shape == (4 * cell,))
    params["lstm_bias"] = lb
    dense_mats = [a for i, (_, a) in enumerate(mats) if i != lstm_i]
    dense_vecs = [v for _, v in vecs if v is not lb]
    if len(dense_mats) < 5 or len(dense_vecs) < 5:
        raise ValueError(
            f"expected 5 dense layers, found {len(dense_mats)} kernels / "
            f"{len(dense_vecs)} biases"
        )
    for slot, w in zip(("h1", "h2", "h3", "h5", "h6"), dense_mats):
        params[slot] = w
    for slot, b in zip(("b1", "b2", "b3", "b5", "b6"), dense_vecs):
        params[slot] = b
    return params


def load_deepspeech(graph_pb, device) -> DeepSpeechNet:
    """A frozen ``.pb`` (path or bytes) → :class:`DeepSpeechNet` at the
    graph's widths, in eval mode on ``device``."""
    from geneface_tpu_torch.convert import deepspeech_state_dict

    params = map_deepspeech_params(read_frozen_graph_consts(graph_pb))
    n_input, n_hidden = params["h1"].shape
    n_cell = params["lstm_kernel"].shape[1] // 4
    with torch.device("meta"):
        net = DeepSpeechNet(n_input, n_hidden, n_cell, params["h6"].shape[1])
    net.load_state_dict(deepspeech_state_dict(params), assign=True)
    return net.to(device).eval()


@torch.inference_mode()
def deepspeech_logits(graph_pb, feats: np.ndarray, device=None,
                      net: DeepSpeechNet | None = None) -> np.ndarray:
    """Frozen ``.pb`` (path or bytes) + MFCC context windows ``[T, 494]`` →
    logits ``[T, 29]`` float32 (``net`` from :func:`load_deepspeech` skips
    reading the graph; ``device`` defaults to the card)."""
    from geneface_tpu_torch import resolve_device

    if net is None:
        net = load_deepspeech(graph_pb, resolve_device(device))
    dev = next(net.parameters()).device
    x = torch.as_tensor(np.asarray(feats, np.float32)).to(dev)
    return net(x).float().cpu().numpy()
