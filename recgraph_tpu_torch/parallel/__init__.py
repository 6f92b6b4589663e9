"""Scale-out: processes over hosts (``distributed``) and reads over a
host's GPUs (``mesh``)."""
