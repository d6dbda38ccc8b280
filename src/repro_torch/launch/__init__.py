"""Command-line entry points of the port (``serve``, ``train``, ``dryrun``)
and the dry run's meshes and input specs (``mesh``, ``specs``)."""
