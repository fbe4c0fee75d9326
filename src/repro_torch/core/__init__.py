"""Core SLA2 math: masks, quantisation, router, attention refs, SLA2."""
