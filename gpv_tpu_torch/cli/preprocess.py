"""Offline preprocessing CLI: raw downloads -> per-task sample JSONs + vocab
(the port's `gpv_tpu.cli.preprocess`: the same files and printed lines).

    python -m gpv_tpu_torch.cli.preprocess data_dir=<dir> [subsets=[train,val]]

Driven by the `configs/data/preprocess_*.yaml` + `configs/data/coco_vocab.yaml`
group (schema of the reference's `configs/data/` hydra group): each task
config supplies its download_dir and annotation-file names; coco_vocab.yaml
supplies min_count. Runs the reference's preprocess_* + create_coco_vocab
steps (`setup_data.sh:1-20`) over the original_split; SCE splits are produced
by `python -m gpv_tpu_torch.cli.make_sce_split`.
"""
import json
import sys
from pathlib import Path


def _subsets(cfg):
    s = cfg.subsets
    return s.split(",") if isinstance(s, str) else list(s)


def main(argv=None):
    from gpv_tpu_torch.data.preprocess import (dump_samples, preprocess_captions,
                                         preprocess_classification,
                                         preprocess_detection,
                                         preprocess_vqa)
    from gpv_tpu_torch.utils.config import load_config

    overrides = list(argv if argv is not None else sys.argv[1:])

    def cfg_for(name):
        return load_config("configs", f"data/{name}", overrides)

    det_cfg = cfg_for("preprocess_coco_detection")
    cls_cfg = cfg_for("preprocess_coco_classification")
    cap_cfg = cfg_for("preprocess_coco_captions")
    vqa_cfg = cfg_for("preprocess_vqa")
    vocab_cfg = cfg_for("coco_vocab")

    for subset in _subsets(det_cfg):
        inst_path = Path(det_cfg.download_dir) / det_cfg.instances[subset]
        # image_info_test2014.json has no 'annotations' — skip like the old
        # missing-file path did instead of crashing on test subsets
        if inst_path.exists():
            inst = json.loads(inst_path.read_text())
            if "annotations" in inst:
                dump_samples(preprocess_detection(inst),
                             Path(det_cfg.exp_dir), subset)
                dump_samples(preprocess_classification(inst),
                             Path(cls_cfg.exp_dir), subset)
        cap_path = Path(cap_cfg.download_dir) / cap_cfg.captions[subset]
        if cap_path.exists():
            caps = json.loads(cap_path.read_text())
            if "annotations" in caps:
                dump_samples(preprocess_captions(caps),
                             Path(cap_cfg.exp_dir), subset)
        q_path = (Path(vqa_cfg.download_dir) / "questions"
                  / vqa_cfg.questions[subset])
        a_path = Path(vqa_cfg.download_dir) / "anno" / vqa_cfg.anno[subset]
        if q_path.exists():
            qs = json.loads(q_path.read_text())
            annos = json.loads(a_path.read_text()) if a_path.exists() else None
            dump_samples(preprocess_vqa(qs, annos),
                         Path(vqa_cfg.exp_dir), subset)

    # vocab over whatever was produced (reference data/create_coco_vocab.py)
    # — read back from the SAME config-driven exp_dirs the dump step used,
    # so exp_name/output_dir overrides can't silently empty the vocab
    from gpv_tpu_torch.data.vocab_builder import build_vocab, write_vocab
    answers = []
    for task_cfg in (cap_cfg, det_cfg, cls_cfg, vqa_cfg):
        for subset in _subsets(det_cfg):
            p = Path(task_cfg.exp_dir) / f"{subset}.json"
            if p.exists():
                for s in json.loads(p.read_text()):
                    if "answer" in s:
                        answers.append(s["answer"])
    vocab, cnt = build_vocab(answers, min_count=int(vocab_cfg.min_count))
    write_vocab(vocab, cnt, Path(vocab_cfg.exp_dir))
    print(f"vocab size: {len(vocab)}")


if __name__ == "__main__":
    main()
