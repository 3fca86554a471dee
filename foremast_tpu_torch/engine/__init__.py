"""The batched health-judgment engine: scoring programs, the judge and
the device state arena of its fit-cache path."""
