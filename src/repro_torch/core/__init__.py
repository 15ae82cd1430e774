"""Federated rounds of the port: FedComLoc, LoCoDL and the baselines on
the account and packed wires, with heterogeneous clients, aggregation
policies and, for million-client populations, availability traces, the
tree sampler, hierarchical aggregation, host-side client stores and
procedural data; the sampled clients split over the ranks of a
``torch.distributed`` group (``distributed.ShardCtx``, DESIGN.md §6)."""

from repro_torch.core.aggregation import (
    AggregationPolicy, HierarchicalPolicy)
from repro_torch.core.client_store import (
    ClientStore, HostStore, InMemoryStore, resolve_store)
from repro_torch.core.clients import (
    NULL_CTX, ClientAvailability, ClientAxisCtx, ClientProfile,
    ClientSchedule, RoundPlan)
from repro_torch.core.fed_data import (
    FederatedData, SyntheticFederatedData)
from repro_torch.core.sampling import TreeSampler

__all__ = ["AggregationPolicy", "HierarchicalPolicy", "ClientStore",
           "HostStore", "InMemoryStore", "resolve_store",
           "ClientAvailability", "ClientAxisCtx", "ClientProfile",
           "ClientSchedule", "NULL_CTX", "RoundPlan", "FederatedData", "SyntheticFederatedData",
           "TreeSampler"]
