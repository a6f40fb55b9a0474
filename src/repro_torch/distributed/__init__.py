"""Distributed runtime (port of `repro.distributed`): sharding rules as
DTensor layouts, int8 gradient compression, GPipe, elasticity."""
