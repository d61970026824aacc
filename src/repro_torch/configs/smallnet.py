"""smallNet — the paper's own architecture (28x28x1 MNIST, 510 params)."""
SMALLNET = dict(
    input_shape=(28, 28, 1), n_classes=10,
    conv_filters=(1, 1), kernel=(2, 2), pool=2,
    params=510, weight_bytes=2040,
    source="smallNet paper §III-A",
)
