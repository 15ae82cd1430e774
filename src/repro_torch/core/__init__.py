"""Federated rounds of the port: FedComLoc on the synchronous account path."""
