"""Recurrent layers: dynamic_lstm / dynamic_gru / simple_rnn, and the
decoder holders of dynamic_decode (counterpart of
paddle_tpu/layers/rnn.py).

Each recurrence is one op (`lstm`, `gru`, `simple_rnn`,
ops/sequence_ops.py) over padded-dense [batch, max_len, feature] inputs
with an optional `length=`; `dynamic_lstm` / `dynamic_gru` take the input
already gate-projected (4H / 3H) by an upstream fc, as Paddle's do.

`dynamic_decode` raises: in static mode as the reference does (build the
loop with While and the array functions), and the dygraph decode waits for
the port's dygraph mode (ROADMAP item 18.2); `beam_search` and
`gather_tree` wait for item 20.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru", "simple_rnn", "dynamic_decode",
           "GreedyEmbeddingDecoder", "BeamSearchDecoder"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 length=None):
    """input: [b, T, 4H] gate-projected; returns (hidden [b, T, H], cell).
    Gate layout {candidate, input, forget, output}. No peepholes."""
    assert not use_peepholes, "peephole LSTM is not supported"
    helper = LayerHelper("lstm")
    H = size // 4
    w = helper.create_parameter(param_attr, [H, 4 * H], dtype=dtype)
    bias = helper.create_parameter(bias_attr, [4 * H], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Weight": [w], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    if length is not None:
        ins["SeqLen"] = [length]
    helper.append_op("lstm", inputs=ins,
                     outputs={"Hidden": [hidden], "Cell": [cell],
                              "LastH": [last_h], "LastC": [last_c]},
                     attrs={"is_reverse": bool(is_reverse),
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                dtype="float32", name=None, length=None):
    """input: [b, T, 3H] gate-projected; returns hidden [b, T, H]; the
    update h = (1 - u) h + u m for origin_mode False."""
    assert not is_reverse, "use sequence_reverse around dynamic_gru"
    helper = LayerHelper("gru")
    H = size
    w = helper.create_parameter(param_attr, [H, 3 * H], dtype=dtype)
    bias = helper.create_parameter(bias_attr, [3 * H], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Weight": [w], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if length is not None:
        ins["SeqLen"] = [length]
    helper.append_op("gru", inputs=ins,
                     outputs={"Hidden": [hidden], "LastH": [last_h]},
                     attrs={"gate_activation": gate_activation,
                            "activation": candidate_activation,
                            "origin_mode": bool(origin_mode)})
    return hidden


def simple_rnn(input, size, param_attr=None, bias_attr=None,
               activation="tanh", h_0=None, dtype="float32", length=None):
    """input: [b, T, H] pre-projected; the vanilla h = act(x + h W)."""
    helper = LayerHelper("simple_rnn")
    w = helper.create_parameter(param_attr, [size, size], dtype=dtype)
    bias = helper.create_parameter(bias_attr, [size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Weight": [w], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if length is not None:
        ins["SeqLen"] = [length]
    helper.append_op("simple_rnn", inputs=ins,
                     outputs={"Hidden": [hidden], "LastH": [last_h]},
                     attrs={"activation": activation})
    return hidden, last_h


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class GreedyEmbeddingDecoder:
    """Argmax token decoder over a step callable:
    step_fn(token_ids [b], state) -> (logits [b, V], next_state)."""

    def __init__(self, step_fn, start_token, end_token):
        self.step_fn = step_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)


class BeamSearchDecoder:
    """Beam-search decoder holder: step_fn(token_ids [b*beam], state) ->
    (logits [b*beam, V], next_state), every state leaf with a leading
    b*beam dim."""

    def __init__(self, step_fn, start_token, end_token, beam_size=4):
        self.step_fn = step_fn
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)


def dynamic_decode(decoder, inits=None, max_step_num=32, batch_size=None,
                   **kwargs):
    """The reference's static mode raises; its dygraph loop needs the
    port's dygraph mode (ROADMAP item 18.2), which the port has not got,
    so every call is a static-mode call."""
    raise NotImplementedError(
        "static-mode dynamic_decode: build the loop with layers.While + "
        "array_write/array_read (one __while__ op); the dygraph decode "
        "waits for the port's dygraph mode (ROADMAP item 18.2)")
