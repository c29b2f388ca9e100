"""What the kinds share: the program's parameters and encoder, checked
against the configuration file, and the reference's encoder."""

from __future__ import annotations


def program_params(config: dict):
    """The program's BfvParams for the configuration; refuses a chain other
    than the one the file states."""
    from fhetpu_torch.bfv.params import BfvParams

    par = BfvParams.create(n=config["n"], t=config["t"])
    if list(par.q_primes) != list(config["q_primes"]):
        raise ValueError(f"the program's q chain {par.q_primes} is not the configuration's "
                         f"{config['q_primes']}")
    return par


def program_encoder(config: dict):
    from fhetpu_torch.bfv.encoder import FractionalEncoder

    e = config["encoder"]
    return FractionalEncoder(config["t"], config["n"], e["n_int"], e["n_frac"], e["base"])


def reference_encoder(config: dict):
    from perfbench.reference.ring import Encoder

    e = config["encoder"]
    return Encoder(config["t"], config["n"], e["n_int"], e["n_frac"], e["base"])
