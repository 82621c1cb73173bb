from pgtformer_tpu_torch.io.video import VideoReader, VideoWriter, sliding_windows
