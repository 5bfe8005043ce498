"""RNN cells building symbolic recurrence (``mxnet_tpu/rnn/rnn_cell.py``).

Reference: ``python/mxnet/rnn/rnn_cell.py:60-962``.  Every cell unrolls
into plain symbol nodes (``FullyConnected``, ``SliceChannel``,
``Activation``, elementwise ops), as in the JAX package, so the variable
names are the JAX package's letter for letter and parameter files cross
packages.  ``FusedRNNCell`` is a stacked (optionally bidirectional)
composition of the explicit cells with the reference's prefixes, not the
``RNN`` op: ``pack_weights``/``unpack_weights`` round-trip its
checkpoints.
"""
from __future__ import annotations

from .. import symbol
from ..base import MXNetError


def _split_steps(inputs, length, layout, in_layout=None):
    """Turn a sequence tensor into per-step symbols (a list passes
    through after a length check).  Returns ``(steps, t_axis)`` where
    ``t_axis`` is the time axis of ``layout``."""
    assert inputs is not None
    t_axis = layout.find("T")
    src_axis = (in_layout or layout).find("T")
    if isinstance(inputs, symbol.Symbol):
        assert len(inputs.list_outputs()) == 1, \
            "unroll doesn't allow grouped symbol as input. Please " \
            "convert to list first or let unroll handle splitting"
        steps = list(symbol.SliceChannel(inputs, axis=src_axis,
                                         num_outputs=length,
                                         squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        steps = inputs
    return steps, t_axis


def _stack_steps(steps, t_axis):
    """Inverse of :func:`_split_steps`: one tensor with a time axis."""
    widened = [symbol.expand_dims(s, axis=t_axis) for s in steps]
    return symbol.Concat(*widened, dim=t_axis)


class _CompoundCell(object):
    """Plumbing shared by cells wrapping a list of children: state
    bookkeeping and weight (un)packing chain through the children in
    order."""

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def _adopt_params(self, children, override):
        if override:
            for child in children:
                assert child._own_params, \
                    "Either specify params for the compound cell or its " \
                    "children, not both."
                child.params._params.update(self.params._params)
        for child in children:
            self.params._params.update(child.params._params)


class RNNParams(object):
    """Prefix-scoped variable container shared between cells
    (reference contract ``rnn_cell.py:60``): ``get`` interns one
    Variable per full name, so weight-tied cells resolve to the same
    symbol node."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        try:
            return self._params[full]
        except KeyError:
            var = self._params[full] = symbol.Variable(full, **kwargs)
            return var


class BaseRNNCell(object):
    """Abstract RNN cell (reference ``rnn_cell.py:90-315``)."""

    def __init__(self, prefix="", params=None):
        self.reset()
        self._prefix = prefix
        self._modified = False
        # a cell owns its parameter container iff it created it; shared
        # containers (weight tying across cells) are never re-owned
        self._own_params = params is None
        self._params = RNNParams(prefix) if params is None else params

    def reset(self):
        self._init_counter = self._counter = -1

    @property
    def params(self):
        self._own_params = False     # a read implies sharing
        return self._params

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def _fetch_projection_params(self, i2h_bias_init=None):
        """Materialize the fused input/hidden projection variables
        (the i2h/h2h weight+bias quartet every gated cell shares)."""
        get = self.params.get
        self._iW, self._hW = get("i2h_weight"), get("h2h_weight")
        self._iB = get("i2h_bias", **({"init": i2h_bias_init}
                                      if i2h_bias_init is not None else {}))
        self._hB = get("h2h_bias")

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            call_kwargs = dict(kwargs)
            if info is not None:
                call_kwargs.setdefault("shape", info["shape"])
            state = func(name="%sbegin_state_%d" % (self._prefix,
                                                    self._init_counter),
                         **call_kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split the fused per-direction weight/bias matrices into one
        entry per gate (checkpoint-name compatible with the reference's
        cuDNN parameter layout)."""
        if not self._gate_names:
            return args.copy()
        out = dict(args)
        h = self._num_hidden
        for part in ("i2h", "h2h"):
            fused_w = out.pop(self._prefix + part + "_weight")
            fused_b = out.pop(self._prefix + part + "_bias")
            for j, gate in enumerate(self._gate_names):
                rows = slice(j * h, (j + 1) * h)
                out[self._prefix + part + gate + "_weight"] = \
                    fused_w[rows].copy()
                out[self._prefix + part + gate + "_bias"] = \
                    fused_b[rows].copy()
        return out

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        if not self._gate_names:
            return args.copy()
        from ..ndarray import concatenate
        out = dict(args)
        for part in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                pieces = [out.pop("%s%s%s_%s" % (self._prefix, part, g, kind))
                          for g in self._gate_names]
                out["%s%s_%s" % (self._prefix, part, kind)] = \
                    concatenate(pieces)
        return out

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Step the cell ``length`` times; with ``merge_outputs`` the
        per-step outputs come back stacked along the time axis."""
        self.reset()
        steps, t_axis = _split_steps(inputs, length, layout)
        states = begin_state if begin_state is not None \
            else self.begin_state()
        outputs = []
        for step_input in steps:
            out, states = self(step_input, states)
            outputs.append(out)
        if merge_outputs:
            outputs = _stack_steps(outputs, t_axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def _projections(self, step_name, inputs, prev_h, num_gates, sep=""):
        """The two dense projections every gate stack is built from."""
        width = self._num_hidden * num_gates
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB, num_hidden=width,
            name="%s%si2h" % (step_name, sep))
        h2h = symbol.FullyConnected(
            data=prev_h, weight=self._hW, bias=self._hB, num_hidden=width,
            name="%s%sh2h" % (step_name, sep))
        return i2h, h2h


class RNNCell(BaseRNNCell):
    """Simple tanh/relu RNN cell (reference ``rnn_cell.py:317``)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._fetch_projection_params()

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._projections(name, inputs, states[0], 1)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference ``rnn_cell.py:365``)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        from ..initializer import LSTMBias
        self._fetch_projection_params(
            i2h_bias_init=LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._projections(name, inputs, states[0], 4)
        pieces = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                     name="%sslice" % name)
        gate = {tag: symbol.Activation(
                    pieces[j], act_type=act, name="%s%s" % (name, tag))
                for j, (tag, act) in enumerate(
                    [("i", "sigmoid"), ("f", "sigmoid"),
                     ("c", "tanh"), ("o", "sigmoid")])}
        next_c = symbol._plus(gate["f"] * states[1], gate["i"] * gate["c"],
                              name="%sstate" % name)
        next_h = symbol._mul(gate["o"],
                             symbol.Activation(next_c, act_type="tanh"),
                             name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference ``rnn_cell.py:428``)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._fetch_projection_params()

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h, h2h = self._projections(name, inputs, prev_h, 3, sep="_")
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, name="%s_i2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, name="%s_h2h_slice" % name)
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name="%s_r_act" % name)
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name="%s_z_act" % name)
        candidate = symbol.Activation(i2h + reset * h2h, act_type="tanh",
                                      name="%s_h_act" % name)
        next_h = symbol._plus((1. - update) * candidate, update * prev_h,
                              name="%sout" % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Stacked (optionally bidirectional) multi-layer RNN.

    The reference backs this with cuDNN's fused kernel and packs all
    parameters into one 1-D array (``rnn_cell.py:497-607``); here, as in
    the JAX package, the same API composes explicit cells (per-layer
    prefixes ``l0_``, ``r0_``... match the reference, so
    ``unpack_weights`` round-trips checkpoints).
    """

    _MODE_CELLS = None  # filled after class definitions

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._stack = SequentialRNNCell()
        for i in range(num_layers):
            if bidirectional:
                self._stack.add(BidirectionalCell(
                    self._make_cell("%sl%d_" % (prefix, i)),
                    self._make_cell("%sr%d_" % (prefix, i)),
                    output_prefix="%sbi_l%d_" % (prefix, i)))
            else:
                self._stack.add(self._make_cell("%sl%d_" % (prefix, i)))
            if dropout > 0 and i != num_layers - 1:
                self._stack.add(DropoutCell(
                    dropout, prefix="%s_dropout%d_" % (prefix, i)))

    def _make_cell(self, prefix):
        mode = self._mode
        if mode == "rnn_relu":
            return RNNCell(self._num_hidden, activation="relu", prefix=prefix)
        if mode == "rnn_tanh":
            return RNNCell(self._num_hidden, activation="tanh", prefix=prefix)
        if mode == "lstm":
            return LSTMCell(self._num_hidden, prefix=prefix,
                            forget_bias=self._forget_bias)
        if mode == "gru":
            return GRUCell(self._num_hidden, prefix=prefix)
        raise MXNetError("unknown RNN mode %s" % mode)

    @property
    def state_info(self):
        return self._stack.state_info

    def begin_state(self, **kwargs):
        return self._stack.begin_state(**kwargs)

    def unpack_weights(self, args):
        return self._stack.unpack_weights(args)

    def pack_weights(self, args):
        return self._stack.pack_weights(args)

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        return self._stack.unroll(length, inputs, begin_state=begin_state,
                                  layout=layout, merge_outputs=merge_outputs)

    def unfuse(self):
        """Return the underlying stack of explicit cells
        (reference ``rnn_cell.py:583`` returns a SequentialRNNCell)."""
        return self._stack


class SequentialRNNCell(_CompoundCell, BaseRNNCell):
    """Stack cells so each feeds the next (reference
    ``rnn_cell.py:685``)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        self._adopt_params([cell], self._override_cell_params)

    def _chunk_states(self, states):
        """Pair each child with its slice of the flat state list."""
        at = 0
        for cell in self._cells:
            width = len(cell.state_info)
            yield cell, states[at:at + width]
            at += width

    def __call__(self, inputs, states):
        self._counter += 1
        collected = []
        for cell, chunk in self._chunk_states(states):
            assert not isinstance(cell, BidirectionalCell)
            inputs, chunk = cell(inputs, chunk)
            collected.extend(chunk)
        return inputs, collected

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        seq = inputs
        final_states = []
        last = len(self._cells) - 1
        for i, (cell, chunk) in enumerate(self._chunk_states(begin_state)):
            seq, chunk = cell.unroll(
                length, inputs=seq, begin_state=chunk, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            final_states.extend(chunk)
        return seq, final_states


class DropoutCell(BaseRNNCell):
    """Apply dropout on input (reference ``rnn_cell.py:763``)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells that modify another cell
    (reference ``rnn_cell.py:797``)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def __call__(self, inputs, states):
        raise NotImplementedError

    def unpack_weights(self, args):        # checkpoint I/O delegates to
        return self.base_cell.unpack_weights(args)

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        assert not self._modified
        # momentarily lift the modified flag so the base cell accepts
        # the call, then re-seal it
        try:
            self.base_cell._modified = False
            return self.base_cell.begin_state(func=init_sym, **kwargs)
        finally:
            self.base_cell._modified = True

    def pack_weights(self, args):          # the wrapped cell's layout
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference ``rnn_cell.py:839``)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(
            symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = symbol.where(mask(p_outputs, next_output), next_output,
                              prev_output) if p_outputs != 0. else next_output
        states = [symbol.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Add a residual connection around a cell (the reference added it
    shortly after v0.9)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol._plus(output, inputs)
        return output, states


class BidirectionalCell(_CompoundCell, BaseRNNCell):
    """Run a forward and a backward cell over the sequence and
    concatenate their per-step outputs (reference ``rnn_cell.py:881``)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._adopt_params([l_cell, r_cell], params is not None)
        self._cells = [l_cell, r_cell]

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, t_axis = _split_steps(inputs, length, layout)
        if begin_state is None:
            begin_state = self.begin_state()
        fwd_cell, bwd_cell = self._cells
        split_at = len(fwd_cell.state_info)
        fwd_out, fwd_states = fwd_cell.unroll(
            length, inputs=steps, begin_state=begin_state[:split_at],
            layout=layout, merge_outputs=False)
        bwd_out, bwd_states = bwd_cell.unroll(
            length, inputs=list(reversed(steps)),
            begin_state=begin_state[split_at:], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(f, b, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (f, b) in enumerate(zip(fwd_out,
                                                  reversed(bwd_out)))]
        if merge_outputs:
            outputs = _stack_steps(outputs, t_axis)
        return outputs, fwd_states + bwd_states
