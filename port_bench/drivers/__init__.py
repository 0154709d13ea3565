"""Drivers of the traffic mixes, by the name a mix's ``driver`` key gives: each module has
``drive(run) -> Outcome``."""
