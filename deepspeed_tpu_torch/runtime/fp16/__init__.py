"""fp16 training support of the port: the dynamic loss scaler."""
