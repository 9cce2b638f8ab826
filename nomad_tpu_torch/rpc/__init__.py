"""The restricted unpickler of the RPC layer (the rest waits for A18)."""
