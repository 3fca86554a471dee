"""The batched health-judgment engine: scoring programs and the judge."""
