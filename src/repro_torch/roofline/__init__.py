"""Storage-tier constants of the simulated clock (``hw``) and the analytic
parameter counts (``params``)."""
