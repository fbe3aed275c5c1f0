"""Distributed runtime of the port: sharding rules on DTensor
(``sharding``), gradient compression and the int8 all-reduce
(``collectives``), elastic mesh planning (``fault_tolerance``, a verbatim
copy)."""
