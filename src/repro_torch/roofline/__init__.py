"""The roofline of the port: the card (``hw.H100``) and the storage-tier
constants of the simulated clock (``hw``), the analytic parameter counts
(``params``), one rank's collectives, operations, bytes and live memory
counted over a run (``comms``), and the three-term roofline from dry-run
artifacts (``analysis``)."""
