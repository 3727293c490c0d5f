"""Network layer of the port: only the analytic comm model so far (the
wire codecs and link simulation are ROADMAP items)."""
