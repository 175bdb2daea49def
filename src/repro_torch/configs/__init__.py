"""Model configurations of the port (``get_config`` / ``smoke_config``)."""
