"""Frame generators, one module a traffic kind, found by the kind's name."""
