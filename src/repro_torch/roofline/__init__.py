"""Roofline model of the dry run: closed-form terms (``analytic``, a
verbatim copy) and the card's datasheet rates, model FLOPs, parameter
counts and the collective inventory (``analysis``)."""
