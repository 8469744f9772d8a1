"""Dataset download CLI (the port's `gpv_tpu.cli.download`), driven by
`configs/data/download.yaml` (URL tree + flags — schema of reference
`configs/data/download.yaml`):

    python -m gpv_tpu_torch.cli.download data_dir=<dir> \
        [download_coco_images_only=True] [download_coco_test_images=True]

Legacy arg names `images_only=`/`include_test_images=` are accepted too.
"""
import sys

_LEGACY = {"images_only": "download_coco_images_only",
           "include_test_images": "download_coco_test_images"}


def main(argv=None):
    from gpv_tpu_torch.data.download import download_all
    from gpv_tpu_torch.utils.config import load_config, to_dict

    overrides = []
    for a in (argv if argv is not None else sys.argv[1:]):
        k, v = a.split("=", 1)
        k = _LEGACY.get(k, k)
        if k in _LEGACY.values():
            v = str(v).lower() in ("true", "1")
        overrides.append(f"{k}={v}")
    cfg = load_config("configs", "data/download", overrides)
    download_all(cfg.data_dir,
                 images_only=bool(cfg.download_coco_images_only),
                 include_test_images=bool(cfg.download_coco_test_images),
                 urls=to_dict(cfg.urls))


if __name__ == "__main__":
    main()
