"""PyTorch/CUDA port of the FedComLoc reproduction (``repro``).

Mirrors the JAX package's module layout (``core``, ``compress``,
``kernels``, ``models``, ``data``, ``launch``, ``configs``, ``optim`` and
``checkpoint``, whose files either package resumes); imports torch and
numpy only.  The model zoo serves (prefill, decode) and trains (the
chunked loss, its gradient through the scans' backward kernels, the
optimizers, ``launch/train.py`` and the one-card FedComLoc round of
``launch/fed_train.py``, on one card or one client a rank of a ``("pod",
"data", "model")`` mesh).  Federated rounds split their sampled clients
over the ranks of a ``torch.distributed`` group and run the wire
shard-local over a model axis (``core/distributed.py``,
``launch/mesh.py``); the dry run is not ported yet.
Entry points take an explicit ``device`` (default ``"cuda"``); the kernels
on the path are hand-written CUDA for Hopper (``kernels/csrc``), and a
CPU tensor runs their plain PyTorch versions.
"""


def not_ported(what: str) -> NotImplementedError:
    """The error every option outside the ported slice raises (the pod
    round's model axis, the dry run's meshes,
    ``prng.choice(replace=True)``)."""
    return NotImplementedError(f"{what} not yet ported; see ROADMAP Queue A")
