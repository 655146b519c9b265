"""The gradient sum of a data-parallel step: one all-reduce of every
parameter's gradient over the cards (the port's ``nccl_grad_sum``).

S, its bytes, is the model's parameter count, from its widths by the
layer list of the port's ``models/birnn.py`` (dense layers w [D, H] and
b [H]; each bidirectional layer's shared projection w, b and its two
recurrent matrices wf, wb [H, H]; the output layer [H, V] and [V]),
times the gradients' bytes (the parameters' dtype).

The least time: every card must send at least (n - 1)/n S over its links
under any algorithm, an in-switch reduction (NVLS, which sends about S)
included: a ring sends twice it, 2 (n - 1)/n S, in its reduce-scatter and
its all-gather.  So the bound cannot pass the time any algorithm takes.
The links: one direction of an H100 SXM's 18 NVLink 4 links, 25 GB/s
each, 450 GB/s.  The adds are not counted: they run at the links' pace.
"""

NVLINK_BYTES_PER_S = 450e9


def parameters(model: dict) -> int:
    """The number of parameters of the model ``model`` describes (the
    ``model`` section of a configuration file)."""
    d, h = model["input_dim"], model["hidden_dim"]
    n = 0
    for _ in range(model["num_pre_layers"]):
        n += d * h + h
        d = h
    for _ in range(model["num_bi_layers"]):
        n += d * h + h + 2 * h * h
        d = h
    for _ in range(model["num_post_layers"]):
        n += d * h + h
        d = h
    return n + d * model["vocab_size"] + model["vocab_size"]


def grad_bytes(model: dict) -> int:
    """S: the bytes of the gradients one sum adds."""
    size = 2 if model["param_dtype"] in ("bfloat16", "float16") else 4
    return size * parameters(model)


def cost(model: dict, chips: int):
    """(operations, bytes each card sends at least) of one sum over
    ``chips`` cards."""
    return 0.0, (chips - 1) / chips * grad_bytes(model)


def least_s(model: dict, chips: int) -> float:
    """The least seconds of one sum at one direction of NVLink."""
    return cost(model, chips)[1] / NVLINK_BYTES_PER_S
