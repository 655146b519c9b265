"""The analytic operations of the acoustic model, a copy of the port's
``utils.profiling.flops_estimate``: per frame, each dense layer's
2 D H, each bidirectional layer's shared projection 2 D H and its two
recurrent products 2 x 2 H H, the output projection 2 H V; a training
step is three times the forward (the backward about twice it)."""


def forward_per_frame(model: dict) -> float:
    d, h = model["input_dim"], model["hidden_dim"]
    fwd = 0.0
    for _ in range(model["num_pre_layers"]):
        fwd += 2.0 * d * h
        d = h
    for _ in range(model["num_bi_layers"]):
        fwd += 2.0 * d * h + 2 * 2.0 * h * h
        d = h
    for _ in range(model["num_post_layers"]):
        fwd += 2.0 * h * h
    return fwd + 2.0 * h * model["vocab_size"]


def train_per_frame(model: dict) -> float:
    return 3.0 * forward_per_frame(model)
