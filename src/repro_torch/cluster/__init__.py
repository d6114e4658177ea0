from .load_balancer import (LoadBalancer, RequestCountLB, PABLB,
                            RoundRobinLB, CacheAwareLB, make_lb)
from .cluster import Cluster, ClusterConfig

__all__ = ["LoadBalancer", "RequestCountLB", "PABLB", "RoundRobinLB",
           "CacheAwareLB", "make_lb", "Cluster", "ClusterConfig"]
