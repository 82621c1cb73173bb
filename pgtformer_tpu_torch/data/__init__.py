"""The VFHQ data pipeline of the training run: clip datasets, blind
degradations, alignment and the prefetching loader (numpy + cv2 on the
host; batches reach the card through ``loader.device_prefetch``)."""
