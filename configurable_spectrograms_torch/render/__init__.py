"""Panel dispatch, host backend, and figure composition."""
