// Compress / decompress entry points + C API — C++ mirror of codec.py.
//
// Self-verifying compression with literal fallback: any parse/verify failure
// leaves the slice in the literal stream, so decompress(compress(x)) == x is
// structural.  Byte-compatible with the Python codec (differential-tested).
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include "container.h"
#include "h264.h"
#include "model.h"
#include "parser.h"
#include "cavlc.h"

namespace avtpu {

struct SliceRec {
  size_t nal_index;
  uint64_t offset, size;  // size = total NAL length (sum of TS segments)
  uint64_t span_end;      // one past the NAL's last byte (spans TS gaps)
  std::vector<std::pair<uint64_t, uint64_t>> segs;  // TS pieces (empty=contig)
  SliceHeader hdr;
  SPS sps;
  PPS pps;
  Bytes rbsp;           // [0]=placeholder + unescaped payload after hdr byte
  size_t cabac_offset;  // into rbsp
  bool lazy = false;    // rbsp holds only a header prefix (streaming walks)

  // lazy walks defer the full-payload unescape until a GOP window actually
  // parses this slice — window rescans then cost only header prefixes
  void materialize(const uint8_t* data) {
    if (!lazy) return;
    Bytes raw = segs.empty()
                    ? Bytes(data + offset, data + offset + size)
                    : nal_payload(data, NalSpan{offset, size, 0, 0, segs});
    Bytes full = unescape_rbsp(raw.data() + 1, raw.size() - 1);
    rbsp.clear();
    rbsp.push_back(0);
    rbsp.insert(rbsp.end(), full.begin(), full.end());
    lazy = false;
  }
};

// canonical-escaping check across possibly-segmented NAL bytes: the escape
// of the unescaped payload must reproduce the original bytes exactly
static bool canonical_nal(const uint8_t* data, const SliceRec& rec,
                          const Bytes& esc) {
  if (esc.size() + 1 != rec.size) return false;
  if (rec.segs.empty())
    return memcmp(esc.data(), data + rec.offset + 1, esc.size()) == 0;
  size_t vi = 0, skip = 1;  // skip the NAL header byte
  for (auto& [o, l] : rec.segs) {
    uint64_t off = o, len = l;
    if (skip) {
      uint64_t s2 = std::min<uint64_t>(skip, len);
      off += s2;
      len -= s2;
      skip -= s2;
    }
    if (len && memcmp(esc.data() + vi, data + off, len) != 0) return false;
    vi += len;
  }
  return vi == esc.size();
}

struct BlockRec {
  int kind;
  // literal
  uint64_t lit_off = 0, lit_len = 0;
  // slice
  uint64_t nal_size = 0;
  Bytes head;
  int mb_count = 0, drop = 0;
  Bytes tail;
  Bytes sstream;       // per-slice scope
  bool has_sstream = false;            // gop scope: stream slot present
  void* gop_stream_model = nullptr;    // gop scope: model finished later
  // v6 TS segmentation: (segment length, following gap bytes) pairs
  std::vector<std::pair<uint64_t, Bytes>> gaps;
};

// fill BlockRec.gaps from a segmented slice record
static void fill_gaps(const uint8_t* data, const SliceRec& rec, BlockRec* b) {
  for (size_t i = 0; i + 1 < rec.segs.size(); i++) {
    auto [o, l] = rec.segs[i];
    uint64_t no = rec.segs[i + 1].first;
    b->gaps.push_back({l, Bytes(data + o + l, data + no)});
  }
}

template <typename W>
static void write_gaps(W& out, const std::vector<std::pair<uint64_t, Bytes>>& gaps) {
  out.varint(gaps.size());
  for (auto& [seg_len, gap] : gaps) {
    out.varint(seg_len);
    out.blob(gap);
  }
}

class Walker {
 public:
  explicit Walker(const uint8_t* data, size_t size, bool lazy = false)
      : lazy_(lazy), data_(data), size_(size) {
    stream_ = demux(data, size);
    if (!stream_) return;
    for (auto& b : stream_->sps_list) {
      try {
        SPS s = parse_sps(b);
        sps_map_[s.sps_id] = s;
        sps_raw_.emplace(s.sps_id, b);
        collect(all_sps_, b);
      } catch (const ParseError&) {
      }
    }
    for (auto& b : stream_->pps_list) {
      try {
        PPS p = parse_pps(b, sps_map_);
        pps_map_[p.pps_id] = p;
        pps_raw_.emplace(p.pps_id, b);
        collect(all_pps_, b);
      } catch (const ParseError&) {
      }
    }
  }

  // iterate slice records; SPS/PPS NALs update maps in-band
  template <typename F>
  void slices(F f) {
    if (!stream_) return;
    for (size_t i = 0; i < stream_->nals.size(); i++) {
      const NalSpan& nal = stream_->nals[i];
      Bytes seg_buf;
      const uint8_t* raw;
      if (nal.segs.empty()) {
        raw = data_ + nal.offset;
      } else {
        seg_buf = nal_payload(data_, nal);
        raw = seg_buf.data();
      }
      if (nal.nal_type == 7) {
        try {
          Bytes b(raw, raw + nal.size);
          SPS s = parse_sps(b);
          auto it = sps_raw_.find(s.sps_id);
          if (it != sps_raw_.end() && it->second != b)
            params_poisoned_ = true;  // conflicting in-band update
          sps_map_[s.sps_id] = s;
          sps_raw_.emplace(s.sps_id, b);
          collect(all_sps_, b);
        } catch (const ParseError&) {
        }
        continue;
      }
      if (nal.nal_type == 8) {
        try {
          Bytes b(raw, raw + nal.size);
          PPS p = parse_pps(b, sps_map_);
          auto it = pps_raw_.find(p.pps_id);
          if (it != pps_raw_.end() && it->second != b)
            params_poisoned_ = true;
          pps_map_[p.pps_id] = p;
          pps_raw_.emplace(p.pps_id, b);
          collect(all_pps_, b);
        } catch (const ParseError&) {
        }
        continue;
      }
      if (nal.nal_type != 1 && nal.nal_type != 5) continue;
      if (params_poisoned_) continue;  // first-wins contract (see decompress)
      SliceRec rec;
      try {
        // lazy: header fields live in the first bytes; unescape a prefix
        // large enough for any slice header, fall back to full on overrun
        size_t take = lazy_ ? std::min<uint64_t>(nal.size, 4096) : nal.size;
        Bytes rbsp = unescape_rbsp(raw + 1, take - 1);
        rec.hdr = parse_slice_header(rbsp, nal.nal_type, nal.nal_ref_idc,
                                     sps_map_, pps_map_, &rec.sps, &rec.pps);
        if (lazy_ && take < nal.size &&
            rec.hdr.cabac_start_byte + 64 >= rbsp.size())
          throw ParseError("prefix too short");  // retried below
        rec.lazy = lazy_ && take < nal.size;
        rec.cabac_offset = 1 + rec.hdr.cabac_start_byte;
        rec.rbsp.clear();
        rec.rbsp.push_back(0);
        if (rec.lazy)  // keep only the header bytes; materialize() rebuilds
          rec.rbsp.insert(rec.rbsp.end(), rbsp.begin(),
                          rbsp.begin() + rec.hdr.cabac_start_byte);
        else
          rec.rbsp.insert(rec.rbsp.end(), rbsp.begin(), rbsp.end());
      } catch (const ParseError&) {
        if (!lazy_) continue;
        try {  // rare: enormous header — redo with the full payload
          Bytes rbsp = unescape_rbsp(raw + 1, nal.size - 1);
          rec.hdr = parse_slice_header(rbsp, nal.nal_type, nal.nal_ref_idc,
                                       sps_map_, pps_map_, &rec.sps, &rec.pps);
          rec.lazy = false;
          rec.rbsp.clear();
          rec.rbsp.push_back(0);
          rec.rbsp.insert(rec.rbsp.end(), rbsp.begin(), rbsp.end());
          rec.cabac_offset = 1 + rec.hdr.cabac_start_byte;
        } catch (const ParseError&) {
          continue;
        }
      }
      rec.nal_index = i;
      rec.offset = nal.offset;
      rec.size = nal.size;
      rec.segs = nal.segs;
      rec.span_end = nal_span_end(nal);
      f(rec);
    }
  }

  const H264Stream* stream() const { return stream_ ? &*stream_ : nullptr; }
  bool lazy_ = false;

  std::map<int, SPS> sps_map_;
  std::map<int, PPS> pps_map_;

  std::map<int, Bytes> sps_raw_, pps_raw_;
  bool params_poisoned_ = false;
  // every distinct parameter-set NAL seen (initial + in-band), in order:
  // the container must carry all sets recoded slices may reference
  std::vector<Bytes> all_sps_, all_pps_;
  void collect(std::vector<Bytes>& lst, const Bytes& b) {
    for (auto& e : lst)
      if (e == b) return;
    lst.push_back(b);
  }

 private:
  const uint8_t* data_;
  size_t size_;
  std::optional<H264Stream> stream_;
};

static Bytes literal_container(const uint8_t* data, size_t size) {
  CWriter out;
  out.out.insert(out.out.end(), {'A', 'V', 'T', 'R'});
  out.u8(kVersion);
  out.u8(0);
  out.u16(SCOPE_STREAM);
  out.varint(0);  // substream_bins
  out.varint(0);
  out.varint(0);
  if (size) {
    out.u8(KIND_LITERAL);
    out.blob(data, size);
  }
  out.u8(KIND_END);
  RecodeModel m;
  out.blob(m.finish());
  return out.out;
}

// the reference's dual ledger (recode.cpp:642-668): per element class,
// recoded bits vs original CABAC bits, printed on AVTPU_BILL=1.  A call
// keeps its own ledger and adds it to the process's under s_bill_mu when it
// ends or unwinds, so that calls on several threads do not race on it.
static uint64_t s_bill_global[K_NCLS], s_cbill_global[K_NCLS];
static std::mutex s_bill_mu;
static const char* kClsNames[K_NCLS] = {
    "ctx", "skip", "imbtype", "i16cbf", "i16cbc0", "i16cbc1", "i16pm1",
    "i16pm0", "pmbtype0", "pmbtype_i", "pmbtype1", "pmbtype2a", "pmbtype2b",
    "bmbtype0", "bmbtype1", "bmbtype2", "bmbtype3", "bmbtype4", "bmbtype5",
    "bmbtype6", "bmbtype7", "bmbtype_i", "psub0", "psub1", "psub2", "bsub0",
    "bsub1", "bsub2", "bsub3", "bsub4", "bsub5", "bsub6", "bsub7", "t8x8",
    "ipredf", "ipredr", "cpred0", "cpred1", "cpred2", "cbpl", "cbpc0",
    "cbpc1", "qpd0", "qpd1", "qpd2", "ref", "mvd", "mvdp", "mvde", "mvdb",
    "mvds", "cbf", "sig", "lvl1", "lvlg", "lvle", "lvlb", "sgn", "nnz",
    "fieldf", "pcmf", "pcm", "simbtype", "vskip", "vmbt", "vsub", "vcpred",
    "vcbp", "vdqp", "vmvd", "vref", "vtok", "vtz", "vrun", "vt1", "vlp",
    "vls", "vipred", "vt8"};

static void dump_bill();

struct BillLedger {
  uint64_t bill[K_NCLS] = {}, cbill[K_NCLS] = {};
  ~BillLedger() { merge(); }
  void merge() {
    std::lock_guard<std::mutex> lock(s_bill_mu);
    for (uint32_t i = 0; i < K_NCLS; i++) {
      s_bill_global[i] += bill[i];
      s_cbill_global[i] += cbill[i];
      bill[i] = cbill[i] = 0;
    }
  }
};

// Thrown by optimistic (journal-free) passes on the first slice failure;
// the caller redoes the whole unit with rollback journaling enabled.
// Parse failures are rare (zero across the corpus), so the fast path pays
// no journaling cost and the slow path only runs on hostile inputs.
struct OptimisticAbort {};

static Bytes compress_inner(const uint8_t* data, size_t size, int scope,
                            bool optimistic) {
  bool per_slice = scope == SCOPE_SLICE;
  bool per_gop = scope == SCOPE_GOP;
  // per-slice models are discarded wholesale on failure, so they never
  // need the journal regardless of the caller's optimistic mode
  bool opt_shared = optimistic && !per_slice;
  BillLedger ledger;  // outlives the models that point into it
  Walker w(data, size);

  std::unique_ptr<RecodeModel> stream_model;
  if (!per_gop) {
    stream_model = std::make_unique<RecodeModel>();
    stream_model->set_optimistic(opt_shared);
  }
  std::vector<std::unique_ptr<RecodeModel>> gop_models;  // kept alive
  bool gop_emitted = false;
  std::vector<BlockRec> blocks;
  uint64_t pos = 0;

  // picture ring
  std::unique_ptr<PicState> cur, prev;
  int slice_id = 0;

  w.slices([&](const SliceRec& rec) {
    bool gop_start =
        per_gop && (!stream_model ||
                    (rec.hdr.idr && rec.hdr.first_mb_in_slice == 0));
    if (gop_start) {
      // fresh GOP: new model + wiped picture ring (no priors cross the IDR)
      if (stream_model) gop_models.push_back(std::move(stream_model));
      stream_model = std::make_unique<RecodeModel>();
      stream_model->set_optimistic(opt_shared);
      gop_emitted = false;
      cur.reset();
      prev.reset();
    }
    bool advance = rec.hdr.first_mb_in_slice == 0 || !cur;

    // canonical escaping check
    {
      Bytes esc = escape_rbsp(rec.rbsp.data() + 1, rec.rbsp.size() - 1);
      if (!canonical_nal(data, rec, esc)) return;
    }

    // scratch state: copy of the candidate current picture
    PicState scratch;
    const PicState* cand_prev;
    if (advance) {
      scratch.init(rec.sps.pic_width_in_mbs,
                   mb_height(rec.sps) >> (rec.hdr.field_pic ? 1 : 0));
      cand_prev = cur.get();
    } else {
      scratch = *cur;  // deep copy
      cand_prev = prev.get();
    }

    int sid = slice_id + 1;
    const uint8_t* payload = rec.rbsp.data() + rec.cabac_offset;
    size_t payload_size = rec.rbsp.size() - rec.cabac_offset;
    int idc = rec.hdr.slice_type == SLICE_I || rec.hdr.slice_type == SLICE_SI
                  ? -1
                  : rec.hdr.cabac_init_idc;

    // per-slice model (slice scope) or shared stream model; single-pass
    // with journal rollback — same flow as the Python snapshot logic.
    std::unique_ptr<RecodeModel> slice_model;
    RecodeModel* model;
    RecodeModel::Snapshot snap{};
    if (per_slice) {
      slice_model = std::make_unique<RecodeModel>();
      slice_model->set_optimistic(true);  // discarded on failure: no journal
      model = slice_model.get();
    } else {
      model = stream_model.get();
      if (!opt_shared) snap = model->snapshot();
    }

    int mb_count, drop;
    Bytes tail;
    uint64_t* s_bill = ledger.bill;
    uint64_t* s_cbill = ledger.cbill;
    static bool s_do_bill = getenv("AVTPU_BILL") != nullptr;
    try {
      if (rec.hdr.cavlc) {
        if (s_do_bill) model->bill = s_bill;
        CavlcCoder c;
        c.init_compress(rec.rbsp.data() + 1, rec.rbsp.size() - 1,
                        rec.hdr.data_bit_offset, model);
        CavlcSliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, &c, sid);
        mb_count = p.parse_slice_data(-1);
        drop = 0;
        tail = c.finish_compress();
      } else {
        Coder c;
        c.init_compress(payload, payload_size, rec.hdr.slice_qp, idc);
        c.model = model;
        if (s_do_bill) {
          model->bill = s_bill;
          c.cabac_bill = s_cbill;
        }
        SliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, cand_prev, &c,
                      sid, per_slice);
        mb_count = p.parse_slice_data(-1);
        if (!c.verify_tail(&drop, &tail)) throw Desync("re-encode mismatch");
      }
      if (!per_slice && !opt_shared) model->commit(snap);
    } catch (const ParseError&) {
      if (opt_shared) throw OptimisticAbort{};
      if (!per_slice) model->rollback(snap);
      return;  // literal fallback
    }

    // commit
    if (advance) {
      prev = std::move(cur);
    }
    cur = std::make_unique<PicState>(std::move(scratch));
    slice_id = sid;

    if (rec.offset > pos) {
      blocks.push_back({KIND_LITERAL, pos, rec.offset - pos});
    }
    BlockRec b;
    b.kind = KIND_SLICE;
    b.nal_size = rec.size;
    b.head.assign(rec.rbsp.begin(), rec.rbsp.begin() + rec.cabac_offset);
    b.head[0] = data[rec.offset];
    b.mb_count = mb_count;
    b.drop = drop;
    b.tail = tail;
    fill_gaps(data, rec, &b);
    if (per_slice) {
      b.sstream = slice_model->finish();
    } else if (per_gop) {
      if (!gop_emitted) {
        gop_emitted = true;
        b.gop_stream_model = stream_model.get();  // finished at serialization
      }
      b.has_sstream = true;
    }
    blocks.push_back(std::move(b));
    pos = rec.span_end;
  });

  if (pos < size) blocks.push_back({KIND_LITERAL, pos, size - pos});

  CWriter out;
  out.out.insert(out.out.end(), {'A', 'V', 'T', 'R'});
  out.u8(kVersion);
  out.u8(0);
  out.u16((uint16_t)scope);
  out.varint(0);  // substream_bins (host single-pass path writes one stream)
  out.varint(w.all_sps_.size());
  for (auto& b : w.all_sps_) out.blob(b);
  out.varint(w.all_pps_.size());
  for (auto& b : w.all_pps_) out.blob(b);
  for (auto& b : blocks) {
    if (b.kind == KIND_LITERAL) {
      out.u8(KIND_LITERAL);
      out.blob(data + b.lit_off, b.lit_len);
    } else {
      out.u8(KIND_SLICE);
      out.varint(b.nal_size);
      out.blob(b.head);
      out.varint(b.mb_count);
      out.varint(b.drop);
      out.blob(b.tail);
      write_gaps(out, b.gaps);
      if (per_slice) {
        out.blob(b.sstream);
      } else if (per_gop) {
        if (b.gop_stream_model)
          out.blob(((RecodeModel*)b.gop_stream_model)->finish());
        else
          out.varint(0);  // continuation: same GOP model
      }
    }
  }
  out.u8(KIND_END);
  if (per_slice || per_gop) {
    out.varint(0);
  } else {
    out.blob(stream_model->finish());
  }
  if (getenv("AVTPU_BILL")) {
    ledger.merge();
    dump_bill();
  }
  return out.out;
}

// ---------------------------------------------------------- parallel GOP --
// Per-GOP compression unit: fully independent given its slice records
// (model + picture ring reset at the IDR; priors never cross GOPs).  This
// is the host-side realization of the GOP sharding axis (SURVEY.md §2) —
// the same decomposition the mesh pipeline uses across chips.
struct GopJob {
  size_t begin, end;  // range into the slice vector
  std::vector<BlockRec> blocks;          // per slice (kind SLICE); ok flag via mb_count>0
  std::vector<uint8_t> ok;
  int first_ok = -1;  // pipelined mode: sstream target (filled post-join)
};

// Two-pass compression (the parse/model split): pass A parses + CABAC
// decode/verifies the slice with the model DEFERRED — per-bin
// (key, pcab, bit) records land in a flat buffer and the model's tables
// stay untouched — then pass B replays the records through the model as a
// tight prefetched array loop (model.h::replay_records).  A failed slice
// truncates the buffer, so the journal/redo machinery is gone entirely:
// the model only ever sees verified slices.  Streams are byte-identical
// to the single-pass interleaved path (same put_bit sequence).
// `pipe` (optional) moves replay to a dedicated model thread: the parse
// thread hands off per-slice record chunks and the pipeline overlaps
// parse of slice k+1 with model coding of slice k (the 2-thread mode for
// files with fewer GOPs than cores).
struct ReplayPipe {
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<std::vector<uint64_t>> q;
  bool done = false;
  static constexpr size_t kMaxDepth = 4;

  void push(std::vector<uint64_t>&& recs) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return q.size() < kMaxDepth; });
    q.push_back(std::move(recs));
    cv_pop.notify_one();
  }
  void finish() {
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_pop.notify_one();
  }
  bool pop(std::vector<uint64_t>* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return !q.empty() || done; });
    if (q.empty()) return false;
    *out = std::move(q.front());
    q.pop_front();
    cv_push.notify_one();
    return true;
  }
};

static void process_gop(const uint8_t* data, std::vector<SliceRec>& sl,
                        GopJob* job, ReplayPipe* pipe = nullptr) {
  // In pipelined mode this model is only the parse thread's defer sink
  // (put_bit appends records; no estimator/pool access) — the replaying
  // model lives on the model thread, so thread-local pools never cross.
  RecodeModel model;
  model.set_optimistic(true);  // replay never rolls back (records are
                               // only replayed after the slice verifies)
  std::vector<uint64_t> recs;
  std::unique_ptr<PicState> cur, prev;
  int slice_id = 0;
  int first_ok = -1;
  job->blocks.resize(job->end - job->begin);
  job->ok.assign(job->end - job->begin, 0);
  for (size_t i = job->begin; i < job->end; i++) {
    SliceRec& rec = sl[i];
    rec.materialize(data);
    size_t k = i - job->begin;
    bool advance = rec.hdr.first_mb_in_slice == 0 || !cur;
    {
      Bytes esc = escape_rbsp(rec.rbsp.data() + 1, rec.rbsp.size() - 1);
      if (!canonical_nal(data, rec, esc)) continue;
    }
    PicState scratch;
    const PicState* cand_prev;
    if (advance) {
      scratch.init(rec.sps.pic_width_in_mbs,
                   mb_height(rec.sps) >> (rec.hdr.field_pic ? 1 : 0));
      cand_prev = cur.get();
    } else {
      scratch = *cur;
      cand_prev = prev.get();
    }
    int sid = slice_id + 1;
    const uint8_t* payload = rec.rbsp.data() + rec.cabac_offset;
    size_t payload_size = rec.rbsp.size() - rec.cabac_offset;
    int idc = rec.hdr.slice_type == SLICE_I || rec.hdr.slice_type == SLICE_SI
                  ? -1
                  : rec.hdr.cabac_init_idc;
    int mb_count, drop;
    Bytes tail;
    recs.clear();
    recs.reserve(payload_size * 20);  // ~18.5 bins/payload byte
    model.set_defer(&recs);
    try {
      if (rec.hdr.cavlc) {
        CavlcCoder c;
        c.init_compress(rec.rbsp.data() + 1, rec.rbsp.size() - 1,
                        rec.hdr.data_bit_offset, &model);
        CavlcSliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, &c, sid);
        mb_count = p.parse_slice_data(-1);
        drop = 0;
        tail = c.finish_compress();
      } else {
        Coder c;
        c.init_compress(payload, payload_size, rec.hdr.slice_qp, idc);
        c.model = &model;
        SliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, cand_prev, &c,
                      sid, false);
        mb_count = p.parse_slice_data(-1);
        if (!c.verify_tail(&drop, &tail)) throw Desync("re-encode mismatch");
      }
    } catch (const ParseError&) {
      model.set_defer(nullptr);
      continue;  // literal fallback; model state untouched
    }
    model.set_defer(nullptr);
    if (pipe)
      pipe->push(std::move(recs));
    else
      model.replay_records(recs.data(), recs.size());
    if (advance) prev = std::move(cur);
    cur = std::make_unique<PicState>(std::move(scratch));
    slice_id = sid;
    BlockRec& b = job->blocks[k];
    b.kind = KIND_SLICE;
    b.nal_size = rec.size;
    b.head.assign(rec.rbsp.begin(), rec.rbsp.begin() + rec.cabac_offset);
    b.head[0] = data[rec.offset];
    b.mb_count = mb_count;
    b.drop = drop;
    b.tail = tail;
    fill_gaps(data, rec, &b);
    job->ok[k] = 1;
    if (first_ok < 0) first_ok = (int)k;
  }
  if (pipe) {
    job->first_ok = first_ok;  // sstream assigned after the model thread
  } else if (first_ok >= 0) {
    job->blocks[first_ok].sstream = model.finish();
  }
}

// GOP-range container fragment (multi-host sharding, SURVEY.md §2/§7 B6):
// processes only GOPs [lo, hi) and emits their block region.  Fragment 0
// (lo<=0) carries the AVTR header; the fragment containing the last GOP
// carries the trailing literal; NO fragment carries the end marker (the
// stitcher appends it), so stitching is pure concatenation and the result
// is byte-identical to the single-process container whenever every slice
// recodes (failed slices may split one literal across a fragment boundary
// into two adjacent literals — still a valid, losslessly decodable
// container).  total_out (optional) receives the file's GOP count.
static Bytes compress_gops_range(const uint8_t* data, size_t size,
                                 int threads, int lo, int hi,
                                 int* total_out) {
  // lazy walk: full payloads unescape only inside the processed GOP range,
  // so windowed streaming callers pay header prefixes for out-of-range GOPs
  Walker w(data, size, /*lazy=*/true);
  std::vector<SliceRec> sl;
  w.slices([&](const SliceRec& rec) { sl.push_back(rec); });

  // GOP boundaries: IDR pictures (or stream start)
  std::vector<GopJob> jobs;
  for (size_t i = 0; i < sl.size(); i++) {
    bool start = jobs.empty() ||
                 (sl[i].hdr.idr && sl[i].hdr.first_mb_in_slice == 0);
    if (start) {
      if (!jobs.empty()) jobs.back().end = i;
      jobs.push_back({i, sl.size(), {}, {}});
    }
  }
  int total = (int)jobs.size();
  if (total_out) *total_out = total;
  bool emit_head = lo <= 0;
  CWriter out;
  if (emit_head) {
    out.out.insert(out.out.end(), {'A', 'V', 'T', 'R'});
    out.u8(kVersion);
    out.u8(0);
    out.u16(SCOPE_GOP);
    out.varint(0);  // substream_bins
    out.varint(w.all_sps_.size());
    for (auto& b : w.all_sps_) out.blob(b);
    out.varint(w.all_pps_.size());
    for (auto& b : w.all_pps_) out.blob(b);
  }
  if (total == 0) {
    if (emit_head && size) {  // sliceless input: one whole-file literal
      out.u8(KIND_LITERAL);
      out.blob(data, size);
    }
    return out.out;
  }
  lo = std::max(0, std::min(lo, total));
  hi = std::max(lo, std::min(hi < 0 ? total : hi, total));
  if (lo == hi) return out.out;  // empty shard (more hosts than GOPs)

  if (hi - lo == 1 && threads >= 2) {
    // single GOP, spare core: 2-thread parse/model pipeline.  The parse
    // thread records per-slice (key, pcab, bit) chunks; the model thread
    // replays them in order — the two serial chains (parser + CABAC
    // xcoder vs model + range encoder) run concurrently.
    GopJob* job = &jobs[lo];
    ReplayPipe pipe;
    Bytes sstream;
    std::thread model_thread([&] {
      RecodeModel model;
      model.set_optimistic(true);
      std::vector<uint64_t> recs;
      bool any = false;
      while (pipe.pop(&recs)) {
        model.replay_records(recs.data(), recs.size());
        any = true;
      }
      if (any) sstream = model.finish();
    });
    process_gop(data, sl, job, &pipe);
    pipe.finish();
    model_thread.join();
    if (job->first_ok >= 0) job->blocks[job->first_ok].sstream = sstream;
  } else {
    std::atomic<size_t> next{(size_t)lo};
    auto worker = [&]() {
      for (;;) {
        size_t j = next.fetch_add(1);
        if (j >= (size_t)hi) return;
        process_gop(data, sl, &jobs[j]);
      }
    };
    int nt = std::max(1, std::min<int>(threads, hi - lo));
    std::vector<std::thread> pool;
    for (int t = 1; t < nt; t++) pool.emplace_back(worker);
    worker();
    for (auto& t : pool) t.join();
  }

  // literals between recoded NALs + slice blocks in order
  uint64_t pos = lo == 0 ? 0 : sl[jobs[lo].begin].offset;
  for (int g = lo; g < hi; g++) {
    GopJob& job = jobs[g];
    for (size_t i = job.begin; i < job.end; i++) {
      size_t k = i - job.begin;
      if (!job.ok[k]) continue;
      const SliceRec& rec = sl[i];
      if (rec.offset > pos) {
        out.u8(KIND_LITERAL);
        out.blob(data + pos, rec.offset - pos);
      }
      BlockRec& b = job.blocks[k];
      out.u8(KIND_SLICE);
      out.varint(b.nal_size);
      out.blob(b.head);
      out.varint(b.mb_count);
      out.varint(b.drop);
      out.blob(b.tail);
      write_gaps(out, b.gaps);
      out.blob(b.sstream);  // empty for continuations
      pos = rec.span_end;
    }
  }
  uint64_t bound = hi == total ? size : sl[jobs[hi].begin].offset;
  if (pos < bound) {
    out.u8(KIND_LITERAL);
    out.blob(data + pos, bound - pos);
  }
  return out.out;
}

static Bytes compress_gop_mt(const uint8_t* data, size_t size, int threads) {
  Bytes out = compress_gops_range(data, size, threads, 0, -1, nullptr);
  CWriter end;
  end.out = std::move(out);
  end.u8(KIND_END);
  end.varint(0);
  return end.out;
}

// -------------------------------------------------------- trace extract --
// Device-pipeline host stage: parse + verify every slice (slice scope,
// isolated priors) and emit container pieces + per-slice bin traces for
// the TPU entropy stage.  Zero-copy handle design: the meta blob carries
// only the container pieces (u8 has_trace marker per slice); the packed
// u64 trace records stay in the recorders' own buffers and are exposed by
// pointer (avtpu_xtrace) until the handle is closed — no serialize/copy of
// the ~100x-inflated trace payload.  Meta blob layout:
//   n_sps, sps blobs; n_pps, pps blobs; n_blocks, then per block:
//     kind=0: literal blob
//     kind=1: varint nal_size; blob head; varint mb_count; varint drop;
//             blob tail; u8 has_trace
// Where an extraction's time went, read by the caller's spans through
// avtpu_xstats.  Times are steady_clock ns (CLOCK_MONOTONIC, the clock of
// Python's time.perf_counter_ns), CPU is CLOCK_THREAD_CPUTIME_ID.  Each GOP
// job writes its own counters on its own thread; they are summed after the
// join, so nothing is shared while the jobs run.  Slice scope is one pass
// on the calling thread, reported as one job (two where the optimistic
// pass is run again) with no walk of its own.
struct XJobTime {
  int64_t tid, t0, t1;
};
struct XStats {
  int64_t t_start = 0, t_walked = 0, t_joined = 0, t_end = 0;
  int64_t threads = 0, jobs = 0, slices = 0, failed = 0;
  int64_t parse_ns = 0, model_ns = 0, job_ns = 0, cpu_ns = 0;
  int64_t field_bins = 0;  // pass A's bins in MBAFF pairs decoded as fields
  std::vector<XJobTime> job_times;
};
static const size_t kXStats = 13;  // counters avtpu_xstats writes

static int64_t steady_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static int64_t thread_cpu_ns() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

static int64_t thread_id() { return (int64_t)syscall(SYS_gettid); }

// A GOP's trace in the lane form: one uint16 code a bin (bits 0-11 the
// squash index of its p1, bit 12 the bin, bits 13-15 zero), all the lane
// coder reads.  The codes live in an anonymous mapping of their own,
// reserved from the GOP's payload bytes and grown by mremap, which moves
// the pages and copies nothing; freeing it unmaps them, so no freed trace
// stays resident in a malloc arena.
class LaneCodes {
 public:
  LaneCodes() = default;
  LaneCodes(LaneCodes&& o) noexcept : p_(o.p_), n_(o.n_), cap_(o.cap_) {
    o.p_ = nullptr;
    o.n_ = o.cap_ = 0;
  }
  LaneCodes& operator=(LaneCodes&& o) noexcept {
    std::swap(p_, o.p_);
    std::swap(n_, o.n_);
    std::swap(cap_, o.cap_);
    return *this;
  }
  LaneCodes(const LaneCodes&) = delete;
  ~LaneCodes() {
    if (p_) munmap(p_, bytes(cap_));
  }

  // room for at least n codes
  void reserve(size_t n) {
    if (n <= cap_) return;
    void* p = p_ ? mremap(p_, bytes(cap_), bytes(n), MREMAP_MAYMOVE)
                 : mmap(nullptr, bytes(n), PROT_READ | PROT_WRITE,
                        MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) throw std::bad_alloc();
    p_ = (uint16_t*)p;
    cap_ = bytes(n) / sizeof(uint16_t);
  }
  // n more codes at the end: where to write them
  uint16_t* extend(size_t n) {
    if (n_ + n > cap_) reserve(std::max(n_ + n, 2 * cap_));
    uint16_t* at = p_ + n_;
    n_ += n;
    return at;
  }
  const uint16_t* data() const { return p_; }
  size_t size() const { return n_; }

 private:
  static size_t bytes(size_t n) {  // n codes, in whole pages
    const size_t page = (size_t)sysconf(_SC_PAGESIZE);
    return (n * sizeof(uint16_t) + page - 1) / page * page;
  }
  uint16_t* p_ = nullptr;
  size_t n_ = 0, cap_ = 0;
};

struct XtractResult {
  Bytes meta;
  std::vector<std::shared_ptr<RecodeModel>> traces;
  std::vector<LaneCodes> lanes;  // the lane form's traces (traces empty)
  // lane-parallel consumers read only (bit, p1) from the records — fields
  // the slot remap never touches — so finalize_trace can be skipped
  bool want_slots = true;
  XStats stats;
};

static XtractResult extract_open_impl(const uint8_t* data, size_t size,
                                      int scope, bool optimistic,
                                      XStats* st) {
  XJobTime pass{thread_id(), steady_ns(), 0};
  int64_t cpu0 = thread_cpu_ns();
  if (!st->t_start) st->t_start = st->t_walked = pass.t0;
  st->threads = 1;
  st->jobs++;
  bool per_gop = scope == SCOPE_GOP;
  bool opt_shared = optimistic && per_gop;
  Walker w(data, size);
  struct XBlock {
    BlockRec b;
    std::shared_ptr<RecodeModel> rec;  // trace carrier (gop: first ok slice)
  };
  std::vector<XBlock> blocks;
  uint64_t pos = 0;
  std::unique_ptr<PicState> cur, prev;
  std::shared_ptr<RecodeModel> gop_rec;  // gop scope: shared recorder
  bool gop_emitted = false;
  int slice_id = 0;

  w.slices([&](const SliceRec& rec) {
    bool gop_start = per_gop && (!gop_rec ||
        (rec.hdr.idr && rec.hdr.first_mb_in_slice == 0));
    if (gop_start) {
      gop_rec = std::make_shared<RecodeModel>(true);
      gop_rec->set_optimistic(opt_shared);
      gop_emitted = false;
      cur.reset();
      prev.reset();
    }
    bool advance = rec.hdr.first_mb_in_slice == 0 || !cur;
    int64_t a0 = steady_ns();
    st->slices++;
    {
      Bytes esc = escape_rbsp(rec.rbsp.data() + 1, rec.rbsp.size() - 1);
      if (!canonical_nal(data, rec, esc)) {
        st->parse_ns += steady_ns() - a0;
        st->failed++;
        return;
      }
    }
    PicState scratch;
    const PicState* cand_prev;
    if (advance) {
      scratch.init(rec.sps.pic_width_in_mbs,
                   mb_height(rec.sps) >> (rec.hdr.field_pic ? 1 : 0));
      cand_prev = cur.get();
    } else {
      scratch = *cur;
      cand_prev = prev.get();
    }
    int sid = slice_id + 1;
    const uint8_t* payload = rec.rbsp.data() + rec.cabac_offset;
    size_t payload_size = rec.rbsp.size() - rec.cabac_offset;
    int idc = rec.hdr.slice_type == SLICE_I || rec.hdr.slice_type == SLICE_SI
                  ? -1
                  : rec.hdr.cabac_init_idc;
    std::shared_ptr<RecodeModel> recorder =
        per_gop ? gop_rec : std::make_shared<RecodeModel>(true);
    recorder->set_optimistic(true);
    recorder->reserve_trace(payload_size * 20);  // ~18.5 bins/payload byte
    // two-pass: pass A defers raw records into the trace buffer; a failed
    // slice truncates them (per-slice recorders are discarded wholesale),
    // so the model/counters never see unverified slices — no journal
    size_t mark = recorder->trace_mark();
    recorder->set_defer_trace(true);
    int mb_count, drop;
    uint64_t field_bins = 0;
    Bytes tail;
    try {
      if (rec.hdr.cavlc) {
        CavlcCoder c;
        c.init_compress(rec.rbsp.data() + 1, rec.rbsp.size() - 1,
                        rec.hdr.data_bit_offset, recorder.get());
        CavlcSliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, &c, sid);
        mb_count = p.parse_slice_data(-1);
        drop = 0;
        tail = c.finish_compress();
      } else {
        Coder c;
        c.init_compress(payload, payload_size, rec.hdr.slice_qp, idc);
        c.model = recorder.get();
        SliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, cand_prev, &c,
                      sid, /*isolate=*/!per_gop);
        mb_count = p.parse_slice_data(-1);
        field_bins = p.field_bins();
        if (!c.verify_tail(&drop, &tail)) throw Desync("re-encode mismatch");
      }
    } catch (const ParseError&) {
      recorder->set_defer_trace(false);
      recorder->truncate_trace(mark);
      st->parse_ns += steady_ns() - a0;
      st->failed++;
      return;
    }
    recorder->set_defer_trace(false);
    int64_t b0 = steady_ns();
    st->parse_ns += b0 - a0;
    st->field_bins += (int64_t)field_bins;
    recorder->replay_trace_tail(mark);
    st->model_ns += steady_ns() - b0;
    if (advance) prev = std::move(cur);
    cur = std::make_unique<PicState>(std::move(scratch));
    slice_id = sid;
    if (rec.offset > pos) {
      XBlock lb;
      lb.b.kind = KIND_LITERAL;
      lb.b.lit_off = pos;
      lb.b.lit_len = rec.offset - pos;
      blocks.push_back(std::move(lb));
    }
    XBlock xb;
    xb.b.kind = KIND_SLICE;
    xb.b.nal_size = rec.size;
    xb.b.head.assign(rec.rbsp.begin(), rec.rbsp.begin() + rec.cabac_offset);
    xb.b.head[0] = data[rec.offset];
    xb.b.mb_count = mb_count;
    xb.b.drop = drop;
    xb.b.tail = tail;
    fill_gaps(data, rec, &xb.b);
    if (!per_gop) {
      xb.rec = recorder;
    } else if (!gop_emitted) {
      gop_emitted = true;
      xb.rec = recorder;  // first ok slice of the GOP carries the trace
    }
    blocks.push_back(std::move(xb));
    pos = rec.span_end;
  });
  if (pos < size) {
    XBlock lb;
    lb.b.kind = KIND_LITERAL;
    lb.b.lit_off = pos;
    lb.b.lit_len = size - pos;
    blocks.push_back(std::move(lb));
  }
  st->cpu_ns += thread_cpu_ns() - cpu0;
  pass.t1 = st->t_joined = steady_ns();
  st->job_ns += pass.t1 - pass.t0;
  st->job_times.push_back(pass);

  XtractResult res;
  CWriter out;
  out.varint(w.all_sps_.size());
  for (auto& b : w.all_sps_) out.blob(b);
  out.varint(w.all_pps_.size());
  for (auto& b : w.all_pps_) out.blob(b);
  out.varint(blocks.size());
  for (auto& xb : blocks) {
    out.u8((uint8_t)xb.b.kind);
    if (xb.b.kind == KIND_LITERAL) {
      out.blob(data + xb.b.lit_off, xb.b.lit_len);
      continue;
    }
    out.varint(xb.b.nal_size);
    out.blob(xb.b.head);
    out.varint(xb.b.mb_count);
    out.varint(xb.b.drop);
    out.blob(xb.b.tail);
    write_gaps(out, xb.b.gaps);
    out.u8(xb.rec ? 1 : 0);  // trace carried? (gop continuations: 0)
    if (xb.rec) res.traces.push_back(xb.rec);
  }
  res.meta = std::move(out.out);
  st->t_end = steady_ns();
  return res;
}

// Threaded trace extraction (gop scope): same GOP-job decomposition as
// compress_gop_mt — model + picture ring reset at the IDR, so jobs are
// fully independent and the stitched meta is byte-identical to the serial
// extract_open.  This is the host-side throughput path feeding the device
// entropy stage (extraction caps the whole device pipeline — Amdahl).
struct XGopJob {
  size_t begin, end;
  std::vector<BlockRec> blocks;
  std::vector<uint8_t> ok;
  std::shared_ptr<RecodeModel> rec;  // GOP recorder (trace carrier)
  LaneCodes lane;                    // the lane form's trace
  int first_ok = -1;
  // written on the job's thread only (see XStats)
  int64_t parse_ns = 0, model_ns = 0, cpu_ns = 0, field_bins = 0;
  XJobTime time{0, 0, 0};
};

// Two-pass trace extraction (same split as process_gop): pass A parses
// with the recorder deferred — raw records append straight into the trace
// buffer — pass B replays the verified slice's records through the model,
// rewriting them in place with the exact p1.  Failed slices truncate the
// buffer; no journal, no redo.
// The lane form (`pass_a` given): pass A appends the slice's records to
// `pass_a`, the GOP thread's buffer, and pass B writes each bin's lane
// code to the end of job->lane; a failed slice leaves only pass_a to
// clear.  The records never leave the thread.
static void process_gop_x_impl(const uint8_t* data,
                               const std::vector<SliceRec>& sl, XGopJob* job,
                               bool want_slots,
                               std::vector<uint64_t>* pass_a) {
  auto recorder = std::make_shared<RecodeModel>(true);
  recorder->set_optimistic(true);
  std::unique_ptr<PicState> cur, prev;
  int slice_id = 0;
  job->blocks.resize(job->end - job->begin);
  job->ok.assign(job->end - job->begin, 0);
  if (pass_a) {
    size_t payload = 0;
    for (size_t i = job->begin; i < job->end; i++)
      payload += sl[i].rbsp.size() - sl[i].cabac_offset;
    job->lane.reserve(payload * 20);  // ~18.5 bins/payload byte
  }
  for (size_t i = job->begin; i < job->end; i++) {
    const SliceRec& rec = sl[i];
    size_t k = i - job->begin;
    bool advance = rec.hdr.first_mb_in_slice == 0 || !cur;
    // pass A: the escape check, parse, CABAC decode and tail verify
    int64_t a0 = steady_ns();
    {
      Bytes esc = escape_rbsp(rec.rbsp.data() + 1, rec.rbsp.size() - 1);
      if (!canonical_nal(data, rec, esc)) {
        job->parse_ns += steady_ns() - a0;
        continue;
      }
    }
    PicState scratch;
    const PicState* cand_prev;
    if (advance) {
      scratch.init(rec.sps.pic_width_in_mbs,
                   mb_height(rec.sps) >> (rec.hdr.field_pic ? 1 : 0));
      cand_prev = cur.get();
    } else {
      scratch = *cur;
      cand_prev = prev.get();
    }
    int sid = slice_id + 1;
    const uint8_t* payload = rec.rbsp.data() + rec.cabac_offset;
    size_t payload_size = rec.rbsp.size() - rec.cabac_offset;
    int idc = rec.hdr.slice_type == SLICE_I || rec.hdr.slice_type == SLICE_SI
                  ? -1
                  : rec.hdr.cabac_init_idc;
    size_t mark = 0;
    if (pass_a) {
      pass_a->clear();
      // at least kScratchFloor records: see extract_open_gop_mt
      if (pass_a->capacity() < payload_size * 20)
        pass_a->reserve(std::max(payload_size * 20, 2 * pass_a->capacity()));
      recorder->set_defer(pass_a);
    } else {
      recorder->reserve_trace(payload_size * 20);
      mark = recorder->trace_mark();
      recorder->set_defer_trace(true);
    }
    int mb_count, drop;
    uint64_t field_bins = 0;
    Bytes tail;
    try {
      if (rec.hdr.cavlc) {
        CavlcCoder c;
        c.init_compress(rec.rbsp.data() + 1, rec.rbsp.size() - 1,
                        rec.hdr.data_bit_offset, recorder.get());
        CavlcSliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, &c, sid);
        mb_count = p.parse_slice_data(-1);
        drop = 0;
        tail = c.finish_compress();
      } else {
        Coder c;
        c.init_compress(payload, payload_size, rec.hdr.slice_qp, idc);
        c.model = recorder.get();
        SliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, cand_prev, &c,
                      sid, false);
        mb_count = p.parse_slice_data(-1);
        field_bins = p.field_bins();
        if (!c.verify_tail(&drop, &tail)) throw Desync("re-encode mismatch");
      }
    } catch (const ParseError&) {
      recorder->set_defer(nullptr);
      if (!pass_a) recorder->truncate_trace(mark);
      job->parse_ns += steady_ns() - a0;
      continue;
    }
    recorder->set_defer(nullptr);
    // pass B: the model replays the slice's records, writing each bin's p1
    // (the lane form: each bin's code)
    int64_t b0 = steady_ns();
    job->parse_ns += b0 - a0;
    job->field_bins += (int64_t)field_bins;
    if (pass_a)
      recorder->replay_lane(pass_a->data(), pass_a->size(),
                            job->lane.extend(pass_a->size()));
    else
      recorder->replay_trace_tail(mark);
    job->model_ns += steady_ns() - b0;
    if (advance) prev = std::move(cur);
    cur = std::make_unique<PicState>(std::move(scratch));
    slice_id = sid;
    BlockRec& b = job->blocks[k];
    b.kind = KIND_SLICE;
    b.nal_size = rec.size;
    b.head.assign(rec.rbsp.begin(), rec.rbsp.begin() + rec.cabac_offset);
    b.head[0] = data[rec.offset];
    b.mb_count = mb_count;
    b.drop = drop;
    b.tail = tail;
    fill_gaps(data, rec, &b);
    job->ok[k] = 1;
    if (job->first_ok < 0) job->first_ok = (int)k;
  }
  if (job->first_ok >= 0 && !pass_a) {
    if (want_slots) recorder->finalize_trace();  // slot remap in the worker
    job->rec = recorder;
  }
}

static void process_gop_x(const uint8_t* data,
                          const std::vector<SliceRec>& sl, XGopJob* job,
                          bool want_slots, std::vector<uint64_t>* pass_a) {
  process_gop_x_impl(data, sl, job, want_slots, pass_a);
}

// The lane form's pass-A scratch holds at least this many records, 32 MiB
// and a record: glibc maps an allocation of that size apart whatever its
// dynamic mmap threshold has grown to (32 MiB at most), and unmaps it when
// freed, so a worker's scratch never stays resident in an arena.  Only the
// pages that its largest slice's records touch become resident.
static const size_t kScratchFloor = (size_t(32) << 20) / 8 + 1;

// `lane`: the lane form, one LaneCodes a GOP in res.lanes (see
// process_gop_x_impl); else res.traces, each GOP's recorder.
static XtractResult extract_open_gop_mt(const uint8_t* data, size_t size,
                                        int threads, bool want_slots,
                                        bool lane = false) {
  XtractResult res;
  res.want_slots = want_slots;
  XStats& st = res.stats;
  st.t_start = steady_ns();
  Walker w(data, size);
  std::vector<SliceRec> sl;
  w.slices([&](const SliceRec& rec) { sl.push_back(rec); });

  std::vector<XGopJob> jobs;
  for (size_t i = 0; i < sl.size(); i++) {
    bool start = jobs.empty() ||
                 (sl[i].hdr.idr && sl[i].hdr.first_mb_in_slice == 0);
    if (start) {
      if (!jobs.empty()) jobs.back().end = i;
      jobs.push_back({i, sl.size(), {}, {}, nullptr, {}, -1});
    }
  }
  st.t_walked = steady_ns();
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    // the lane form's pass-A records: one slice at a time, this thread's
    std::vector<uint64_t> scratch;
    if (lane) scratch.reserve(kScratchFloor);
    for (;;) {
      size_t j = next.fetch_add(1);
      if (j >= jobs.size()) return;
      XGopJob& job = jobs[j];
      job.time = {thread_id(), steady_ns(), 0};
      int64_t cpu0 = thread_cpu_ns();
      process_gop_x(data, sl, &job, want_slots, lane ? &scratch : nullptr);
      job.cpu_ns = thread_cpu_ns() - cpu0;
      job.time.t1 = steady_ns();
    }
  };
  int nt = std::max(1, std::min<int>(threads, (int)jobs.size()));
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; t++) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  st.t_joined = steady_ns();
  st.threads = nt;
  for (auto& job : jobs) {
    st.jobs++;
    st.slices += job.end - job.begin;
    for (uint8_t ok : job.ok) st.failed += !ok;
    st.parse_ns += job.parse_ns;
    st.model_ns += job.model_ns;
    st.field_bins += job.field_bins;
    st.cpu_ns += job.cpu_ns;
    st.job_ns += job.time.t1 - job.time.t0;
    st.job_times.push_back(job.time);
  }

  CWriter out;
  out.varint(w.all_sps_.size());
  for (auto& b : w.all_sps_) out.blob(b);
  out.varint(w.all_pps_.size());
  for (auto& b : w.all_pps_) out.blob(b);
  // count blocks first (literal gaps + ok slices), then emit
  uint64_t pos = 0;
  size_t n_blocks = 0;
  for (auto& job : jobs)
    for (size_t i = job.begin; i < job.end; i++) {
      if (!job.ok[i - job.begin]) continue;
      if (sl[i].offset > pos) n_blocks++;
      n_blocks++;
      pos = sl[i].span_end;
    }
  if (pos < size) n_blocks++;
  out.varint(n_blocks);
  pos = 0;
  for (auto& job : jobs) {
    for (size_t i = job.begin; i < job.end; i++) {
      size_t k = i - job.begin;
      if (!job.ok[k]) continue;
      const SliceRec& rec = sl[i];
      if (rec.offset > pos) {
        out.u8(KIND_LITERAL);
        out.blob(data + pos, rec.offset - pos);
      }
      BlockRec& b = job.blocks[k];
      out.u8(KIND_SLICE);
      out.varint(b.nal_size);
      out.blob(b.head);
      out.varint(b.mb_count);
      out.varint(b.drop);
      out.blob(b.tail);
      write_gaps(out, b.gaps);
      bool carries = (int)k == job.first_ok;
      out.u8(carries ? 1 : 0);
      if (carries && lane)
        res.lanes.push_back(std::move(job.lane));
      else if (carries)
        res.traces.push_back(job.rec);
      pos = rec.span_end;
    }
  }
  if (pos < size) {
    out.u8(KIND_LITERAL);
    out.blob(data + pos, size - pos);
  }
  res.meta = std::move(out.out);
  st.t_end = steady_ns();
  return res;
}

static XtractResult extract_open(const uint8_t* data, size_t size, int scope) {
  XStats st;
  XtractResult res;
  try {
    res = extract_open_impl(data, size, scope, /*optimistic=*/true, &st);
  } catch (const OptimisticAbort&) {
    res = extract_open_impl(data, size, scope, /*optimistic=*/false, &st);
  }
  res.stats = std::move(st);
  return res;
}

static void dump_bill() {
  std::lock_guard<std::mutex> lock(s_bill_mu);
  fprintf(stderr, "%12s %12s %12s %10s\n", "class", "cabac_bits", "recode_bits",
          "delta");
  uint64_t tc = 0, tm = 0;
  for (uint32_t i = 0; i < K_NCLS; i++) {
    if (!s_bill_global[i] && !s_cbill_global[i]) continue;
    fprintf(stderr, "%12s %12llu %12llu %10lld\n", kClsNames[i],
            (unsigned long long)s_cbill_global[i],
            (unsigned long long)s_bill_global[i],
            (long long)s_bill_global[i] - (long long)s_cbill_global[i]);
    tc += s_cbill_global[i];
    tm += s_bill_global[i];
  }
  fprintf(stderr, "%12s %12llu %12llu %10lld\n", "TOTAL",
          (unsigned long long)tc, (unsigned long long)tm,
          (long long)tm - (long long)tc);
}

Bytes compress(const uint8_t* data, size_t size, int scope, int threads) {
  try {
    if (scope == SCOPE_GOP) {
      // all gop-scope compression rides the GOP-job path (two-pass
      // parse/model split; threads==1 runs the jobs serially) — outputs
      // are byte-identical to the legacy interleaved path
      int nt = threads > 0 ? threads
                           : std::min(16u, std::thread::hardware_concurrency());
      return compress_gop_mt(data, size, std::max(1, nt));
    }
    try {
      return compress_inner(data, size, scope, /*optimistic=*/true);
    } catch (const OptimisticAbort&) {
      return compress_inner(data, size, scope, /*optimistic=*/false);
    }
  } catch (...) {
    return literal_container(data, size);
  }
}

struct DBlock {
  int kind;
  Bytes lit;
  uint64_t nal_size = 0;
  Bytes head, tail, sstream;
  int mb_count = 0, drop = 0;
  std::vector<std::pair<uint64_t, Bytes>> gaps;  // v6 TS segmentation
};

// Decode one recoded slice block -> reconstructed NAL bytes (appended to
// out), updating the model/picture-ring decode state.
struct DecodeState {
  std::unique_ptr<RecodeModel> stream_model;  // stream/gop scope
  std::unique_ptr<PicState> cur, prev;
  int slice_id = 0;
};

static void decode_slice_block(const DBlock& b, int scope, uint32_t sub_bins,
                               const std::map<int, SPS>& sps_map,
                               const std::map<int, PPS>& pps_map,
                               DecodeState* st, Bytes* out) {
  int nal_type = b.head[0] & 0x1F;
  int nal_ref_idc = (b.head[0] >> 5) & 3;
  Bytes hdr_rbsp(b.head.begin() + 1, b.head.end());
  SPS sps;
  PPS pps;
  SliceHeader hdr = parse_slice_header(hdr_rbsp, nal_type, nal_ref_idc,
                                       sps_map, pps_map, &sps, &pps);
  std::unique_ptr<RecodeModel> slice_model;
  RecodeModel* model;
  if (scope == SCOPE_SLICE) {
    slice_model = std::make_unique<RecodeModel>(b.sstream.data(),
                                                b.sstream.size(), sub_bins);
    model = slice_model.get();
  } else if (scope == SCOPE_GOP) {
    if (!b.sstream.empty()) {  // GOP start: new model, wiped ring
      st->stream_model = std::make_unique<RecodeModel>(
          b.sstream.data(), b.sstream.size(), sub_bins);
      st->cur.reset();
      st->prev.reset();
    }
    model = st->stream_model.get();
  } else {
    model = st->stream_model.get();
  }
  if (!model) throw ParseError("slice block without model stream");
  if (hdr.first_mb_in_slice == 0 || !st->cur) {
    st->prev = std::move(st->cur);
    st->cur = std::make_unique<PicState>();
    st->cur->init(sps.pic_width_in_mbs,
                  mb_height(sps) >> (hdr.field_pic ? 1 : 0));
  }
  st->slice_id++;
  Bytes rbsp;
  if (hdr.cavlc) {
    // regenerate the bitstream from the modeled bits; the writer is seeded
    // with the partial byte's header bits, so its first byte reproduces
    // head's last byte (dropped from head below)
    int pb = (int)(hdr.data_bit_offset & 7);
    uint32_t seed = pb ? (uint32_t)(b.head.back() >> (8 - pb)) : 0;
    CavlcCoder c;
    c.init_decompress(model, seed, pb);
    CavlcSliceParser p(sps, pps, hdr, st->cur.get(), &c, st->slice_id);
    p.parse_slice_data(b.mb_count);
    const Bytes& payload = c.finish_decompress();
    rbsp.assign(b.head.begin() + 1, b.head.end() - (pb ? 1 : 0));
    rbsp.insert(rbsp.end(), payload.begin(), payload.end() - b.drop);
    rbsp.insert(rbsp.end(), b.tail.begin(), b.tail.end());
  } else {
    int idc = hdr.slice_type == SLICE_I || hdr.slice_type == SLICE_SI
                  ? -1
                  : hdr.cabac_init_idc;
    Coder c;
    c.init_decompress(hdr.slice_qp, idc, model);
    SliceParser p(sps, pps, hdr, st->cur.get(), st->prev.get(), &c,
                  st->slice_id, scope == SCOPE_SLICE);
    p.parse_slice_data(b.mb_count);
    const Bytes& payload = c.enc.bytes();
    rbsp.assign(b.head.begin() + 1, b.head.end());
    rbsp.insert(rbsp.end(), payload.begin(), payload.end() - b.drop);
    rbsp.insert(rbsp.end(), b.tail.begin(), b.tail.end());
  }
  Bytes esc = escape_rbsp(rbsp.data(), rbsp.size());
  if (esc.size() + 1 != b.nal_size) throw ParseError("NAL size mismatch");
  Bytes nal;
  nal.reserve(b.nal_size);
  nal.push_back(b.head[0]);
  nal.insert(nal.end(), esc.begin(), esc.end());
  if (b.gaps.empty()) {
    out->insert(out->end(), nal.begin(), nal.end());
    return;
  }
  // TS: re-scatter the NAL into its original segments around the gap bytes
  // (segment lengths come from the container: bounds-check against the
  // rebuilt NAL so corrupt inputs fail loudly instead of over-reading)
  size_t p2 = 0;
  for (auto& [seg_len, gap] : b.gaps) {
    if (seg_len > nal.size() || p2 > nal.size() - seg_len)
      throw ParseError("segmented slice lengths exceed NAL");
    out->insert(out->end(), nal.begin() + p2, nal.begin() + p2 + seg_len);
    out->insert(out->end(), gap.begin(), gap.end());
    p2 += seg_len;
  }
  out->insert(out->end(), nal.begin() + p2, nal.end());
}

Bytes decompress(const uint8_t* data, size_t size, int threads) {
  CReader r{data, size};
  if (size < 8 || memcmp(data, "AVTR", 4) != 0) throw ParseError("bad magic");
  r.pos = 4;
  if (r.u8() != kVersion) throw ParseError("bad version");
  r.u8();
  int scope = r.u16();
  uint32_t substream_bins = (uint32_t)r.varint();
  bool per_slice = scope != SCOPE_STREAM;  // slice/gop: per-block stream slot

  std::map<int, SPS> sps_map;
  std::map<int, PPS> pps_map;
  uint64_t n_sps = r.varint();
  for (uint64_t i = 0; i < n_sps; i++) {
    Bytes b = r.blob();
    SPS s = parse_sps(b);
    sps_map.emplace(s.sps_id, s);  // first definition wins (Walker contract)
  }
  uint64_t n_pps = r.varint();
  for (uint64_t i = 0; i < n_pps; i++) {
    Bytes b = r.blob();
    PPS p = parse_pps(b, sps_map);
    pps_map.emplace(p.pps_id, p);
  }

  std::vector<DBlock> blocks;
  for (;;) {
    int kind = r.u8();
    if (kind == KIND_END) break;
    DBlock b;
    b.kind = kind;
    if (kind == KIND_LITERAL) {
      b.lit = r.blob();
    } else if (kind == KIND_SLICE) {
      b.nal_size = r.varint();
      b.head = r.blob();
      b.mb_count = (int)r.varint();
      b.drop = (int)r.varint();
      b.tail = r.blob();
      uint64_t n_gaps = r.varint();
      for (uint64_t g = 0; g < n_gaps; g++) {
        uint64_t seg_len = r.varint();
        b.gaps.push_back({seg_len, r.blob()});
      }
      if (per_slice) b.sstream = r.blob();
    } else {
      throw ParseError("bad block kind");
    }
    blocks.push_back(std::move(b));
  }
  Bytes stream_bytes = r.blob();

  // parallel GOP decode: split slice blocks into GOP ranges (a non-empty
  // stream slot marks a GOP start); each range decodes independently
  if (scope == SCOPE_GOP && threads != 1) {
    int nt = threads > 0 ? threads
                         : std::min(16u, std::thread::hardware_concurrency());
    std::vector<std::pair<size_t, size_t>> groups;  // block index ranges
    for (size_t i = 0; i < blocks.size(); i++) {
      if (blocks[i].kind != KIND_SLICE) continue;
      if (!blocks[i].sstream.empty() || groups.empty())
        groups.push_back({i, blocks.size()});
      if (groups.size() > 1) groups[groups.size() - 2].second = groups.back().first;
    }
    std::vector<Bytes> nal_out(blocks.size());
    std::atomic<size_t> next{0};
    std::atomic<bool> failed{false};
    auto worker = [&]() {
      for (;;) {
        size_t g = next.fetch_add(1);
        if (g >= groups.size() || failed.load()) return;
        DecodeState st;
        try {
          for (size_t i = groups[g].first; i < groups[g].second; i++) {
            if (blocks[i].kind != KIND_SLICE) continue;
            decode_slice_block(blocks[i], scope, substream_bins, sps_map,
                               pps_map, &st, &nal_out[i]);
          }
        } catch (...) {
          failed.store(true);
          return;
        }
      }
    };
    int n = std::max(1, std::min<int>(nt, (int)groups.size()));
    std::vector<std::thread> pool;
    for (int t = 1; t < n; t++) pool.emplace_back(worker);
    worker();
    for (auto& t : pool) t.join();
    if (failed.load()) throw ParseError("parallel decode failed");
    Bytes out;
    for (size_t i = 0; i < blocks.size(); i++) {
      if (blocks[i].kind == KIND_LITERAL)
        out.insert(out.end(), blocks[i].lit.begin(), blocks[i].lit.end());
      else
        out.insert(out.end(), nal_out[i].begin(), nal_out[i].end());
    }
    return out;
  }

  DecodeState st;
  if (!per_slice)
    st.stream_model = std::make_unique<RecodeModel>(
        stream_bytes.data(), stream_bytes.size(), substream_bins);
  Bytes out;
  for (auto& b : blocks) {
    if (b.kind == KIND_LITERAL) {
      out.insert(out.end(), b.lit.begin(), b.lit.end());
      continue;
    }
    decode_slice_block(b, scope, substream_bins, sps_map, pps_map, &st, &out);
  }
  return out;
}

// ------------------------------------------------------ reference scorer --
// Serial whole-file walk with the reference-model replay attached
// (refscore.h) and no model of our own: produces the reference's idealized
// recode-stream size for the ratio-parity table (BENCHMARKS.md).
// out[0]=ref stream bytes  out[1]=cabac payload bytes  out[2]=slices ok
// out[3]=slices failed     out[4]=bins scored
// out[5..9]=bits by class (ctx, bypass, terminate, nnz, sig)
static int refscore_run(const uint8_t* data, size_t size, double* out) {
  Walker w(data, size);
  RefScorer sc;
  sc.kRefSig8x8 = kSig8x8;  // frame row == recode.cpp sig_coeff_flag_offset_8x8[0]
  std::unique_ptr<PicState> cur, prev;
  uint64_t payload_bytes = 0, n_ok = 0, n_failed = 0;
  int slice_id = 0;

  w.slices([&](const SliceRec& rec) {
    if (rec.hdr.cavlc) return;  // reference model scores CABAC bins only
    {
      Bytes esc = escape_rbsp(rec.rbsp.data() + 1, rec.rbsp.size() - 1);
      if (!canonical_nal(data, rec, esc)) return;
    }
    bool advance = rec.hdr.first_mb_in_slice == 0 || !cur;
    PicState scratch;
    const PicState* cand_prev;
    if (advance) {
      scratch.init(rec.sps.pic_width_in_mbs,
                   mb_height(rec.sps) >> (rec.hdr.field_pic ? 1 : 0));
      cand_prev = cur.get();
    } else {
      scratch = *cur;
      cand_prev = prev.get();
    }
    int sid = slice_id + 1;
    const uint8_t* payload = rec.rbsp.data() + rec.cabac_offset;
    size_t payload_size = rec.rbsp.size() - rec.cabac_offset;
    int idc = rec.hdr.slice_type == SLICE_I || rec.hdr.slice_type == SLICE_SI
                  ? -1
                  : rec.hdr.cabac_init_idc;
    if (advance)  // reference frame_spec hook fires at slice start
      sc.frame_start(rec.sps.pic_width_in_mbs,
                     mb_height(rec.sps) >> (rec.hdr.field_pic ? 1 : 0));
    sc.begin_slice();
    try {
      Coder c;
      c.init_compress(payload, payload_size, rec.hdr.slice_qp, idc);
      c.ref = &sc;
      SliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, cand_prev, &c, sid,
                    /*isolate=*/false);
      p.parse_slice_data(-1);
      int drop;
      Bytes tail;
      if (!c.verify_tail(&drop, &tail)) throw Desync("re-encode mismatch");
    } catch (const ParseError&) {
      // the reference (full ffmpeg decoder) would have recoded this slice;
      // excluded from BOTH sides of the comparison (estimator pollution from
      // the partial walk noted; zero failures on the bench corpus)
      n_failed++;
      return;
    }
    sc.commit_slice();
    payload_bytes += payload_size;
    n_ok++;
    if (advance) prev = std::move(cur);
    cur = std::make_unique<PicState>(std::move(scratch));
    slice_id = sid;
  });
  out[0] = sc.stream_bytes;
  out[1] = (double)payload_bytes;
  out[2] = (double)n_ok;
  out[3] = (double)n_failed;
  out[4] = (double)sc.n_bins;
  for (int i = 0; i < 5; i++) out[5 + i] = sc.bits[i];
  return 0;
}

// -------------------------------------------------------------- mix lab --
// Serial whole-file walk with the model-upgrade laboratory attached
// (mixlab.h): candidate vs production probability model on the real bin
// stream, GOP-scoped like the production model.
// params: [variant, lr, w_est, w_cab, sse_rate]
// out: [bits_base, bits_mix, n_bins, slices_ok, slices_failed]
static int mixlab_run(const uint8_t* data, size_t size, const double* params,
                      double* out) {
  Walker w(data, size);
  MixLab lab;
  lab.variant = (int)params[0];
  lab.lr = params[1];
  lab.w_est = params[2];
  lab.w_cab = params[3];
  lab.sse_rate = params[4];
  std::unique_ptr<PicState> cur, prev;
  uint64_t n_ok = 0, n_failed = 0;
  int slice_id = 0;
  bool started = false;

  w.slices([&](const SliceRec& rec) {
    if (rec.hdr.cavlc) return;  // the lab A/Bs the CABAC model path only
    {
      Bytes esc = escape_rbsp(rec.rbsp.data() + 1, rec.rbsp.size() - 1);
      if (!canonical_nal(data, rec, esc)) return;
    }
    if (!started || (rec.hdr.idr && rec.hdr.first_mb_in_slice == 0)) {
      started = true;
      lab.gop_start();
      cur.reset();
      prev.reset();
    }
    lab.slice_qp = rec.hdr.slice_qp;
    bool advance = rec.hdr.first_mb_in_slice == 0 || !cur;
    PicState scratch;
    const PicState* cand_prev;
    if (advance) {
      scratch.init(rec.sps.pic_width_in_mbs,
                   mb_height(rec.sps) >> (rec.hdr.field_pic ? 1 : 0));
      cand_prev = cur.get();
    } else {
      scratch = *cur;
      cand_prev = prev.get();
    }
    int sid = slice_id + 1;
    const uint8_t* payload = rec.rbsp.data() + rec.cabac_offset;
    size_t payload_size = rec.rbsp.size() - rec.cabac_offset;
    int idc = rec.hdr.slice_type == SLICE_I || rec.hdr.slice_type == SLICE_SI
                  ? -1
                  : rec.hdr.cabac_init_idc;
    try {
      Coder c;
      c.init_compress(payload, payload_size, rec.hdr.slice_qp, idc);
      c.mix = &lab;
      SliceParser p(rec.sps, rec.pps, rec.hdr, &scratch, cand_prev, &c, sid,
                    /*isolate=*/false);
      p.parse_slice_data(-1);
      int drop;
      Bytes tail;
      if (!c.verify_tail(&drop, &tail)) throw Desync("re-encode mismatch");
    } catch (const ParseError&) {
      n_failed++;
      return;
    }
    n_ok++;
    if (advance) prev = std::move(cur);
    cur = std::make_unique<PicState>(std::move(scratch));
    slice_id = sid;
  });
  out[0] = lab.bits_base;
  out[1] = lab.bits_mix;
  out[2] = (double)lab.n_bins;
  out[3] = (double)n_ok;
  out[4] = (double)n_failed;
  return 0;
}

}  // namespace avtpu

// ----------------------------------------------------------------- C API --
extern "C" {

// Returns malloc'd buffer in *out (caller frees with avtpu_free), size as
// return value; scope: 0=stream, 1=slice, 2=gop. Never fails (literal
// fallback).  threads: 0=auto, 1=serial; >1 parallel GOPs (gop scope).
size_t avtpu_compress_mt(const uint8_t* data, size_t size, int scope,
                         int threads, uint8_t** out) {
  avtpu::Bytes b = avtpu::compress(data, size, scope, threads);
  *out = (uint8_t*)malloc(b.size());
  memcpy(*out, b.data(), b.size());
  return b.size();
}

size_t avtpu_compress(const uint8_t* data, size_t size, int scope,
                      uint8_t** out) {
  return avtpu_compress_mt(data, size, scope, 1, out);
}

// Returns 0 and sets *out=nullptr on error. threads: 0=auto, 1=serial.
size_t avtpu_decompress_mt(const uint8_t* data, size_t size, int threads,
                           uint8_t** out) {
  try {
    avtpu::Bytes b = avtpu::decompress(data, size, threads);
    *out = (uint8_t*)malloc(b.size());
    memcpy(*out, b.data(), b.size());
    return b.size();
  } catch (...) {
    *out = nullptr;
    return 0;
  }
}

size_t avtpu_decompress(const uint8_t* data, size_t size, uint8_t** out) {
  return avtpu_decompress_mt(data, size, 1, out);
}

// Device-pipeline host stage: container pieces + per-slice bin traces.
// Handle API, zero-copy: the returned handle owns the trace buffers; the
// meta blob and per-trace record pointers stay valid until avtpu_xclose.
// Returns nullptr on error.
// threads: 1=serial, 0=auto (parallel GOP jobs, gop scope only).
void* avtpu_xopen(const uint8_t* data, size_t size, int scope, int threads,
                  int want_slots, const uint8_t** meta, size_t* meta_len,
                  size_t* n_traces) {
  try {
    if (scope == avtpu::SCOPE_GOP) {
      // all gop-scope extraction rides the GOP-job two-pass path
      // (threads==1 runs the jobs serially)
      int nt = threads > 0
                   ? threads
                   : std::min(16u, std::thread::hardware_concurrency());
      auto* h = new avtpu::XtractResult(
          avtpu::extract_open_gop_mt(data, size, nt, want_slots != 0));
      *meta = h->meta.data();
      *meta_len = h->meta.size();
      *n_traces = h->traces.size();
      return h;
    }
    auto* h = new avtpu::XtractResult(avtpu::extract_open(data, size, scope));
    h->want_slots = want_slots != 0;
    *meta = h->meta.data();
    *meta_len = h->meta.size();
    *n_traces = h->traces.size();
    return h;
  } catch (...) {
    *meta = nullptr;
    *meta_len = 0;
    *n_traces = 0;
    return nullptr;
  }
}

// The lane form of the gop-scope extraction: the same meta as
// avtpu_xopen's, and each GOP's trace as one uint16 code a bin (bits 0-11
// the squash index of its p1, bit 12 the bin, bits 13-15 zero; read by
// avtpu_xlane) in place of the u64 records.  The handle takes
// avtpu_xstats and avtpu_xclose, not avtpu_xtrace.  threads as
// avtpu_xopen's.  Returns nullptr on error.
void* avtpu_xopen_lane(const uint8_t* data, size_t size, int threads,
                       const uint8_t** meta, size_t* meta_len,
                       size_t* n_traces) {
  try {
    int nt = threads > 0 ? threads
                         : std::min(16u, std::thread::hardware_concurrency());
    auto* h = new avtpu::XtractResult(avtpu::extract_open_gop_mt(
        data, size, nt, /*want_slots=*/false, /*lane=*/true));
    *meta = h->meta.data();
    *meta_len = h->meta.size();
    *n_traces = h->lanes.size();
    return h;
  } catch (...) {
    *meta = nullptr;
    *meta_len = 0;
    *n_traces = 0;
    return nullptr;
  }
}

// trace i of a lane-form handle: its codes and their count
void avtpu_xlane(void* handle, size_t i, const uint16_t** codes,
                 size_t* n_bins) {
  const avtpu::LaneCodes& t = ((avtpu::XtractResult*)handle)->lanes[i];
  *codes = t.data();
  *n_bins = t.size();
}

void avtpu_xtrace(void* handle, size_t i, const uint64_t** recs,
                  size_t* n_bins, const uint8_t** limits, const uint8_t** cls,
                  size_t* n_slots) {
  auto* h = (avtpu::XtractResult*)handle;
  if (h->want_slots)
    h->traces[i]->finalize_trace();  // no-op when the worker already did
  const avtpu::RecodeModel::Trace* t = h->traces[i]->trace();
  *recs = t->recs.data();
  *n_bins = t->recs.size();
  *limits = t->limits.data();
  *cls = t->cls.data();
  *n_slots = t->limits.size();
}

void avtpu_xclose(void* handle) { delete (avtpu::XtractResult*)handle; }

// Where the extraction behind the handle spent its time (XStats): the
// first min(n, 13) of its counters into out: steady_clock ns at its start,
// at the end of the walk, at the GOP jobs' join and at its end; the job
// pool's threads; the jobs, their slices and the slices not recoded; pass
// A (parse) and pass B (model) ns, summed over the slices; the jobs' wall
// and thread CPU ns, summed over them; pass A's bins in MBAFF pairs
// decoded as fields.  Then the first max_jobs jobs' (thread id, start ns,
// end ns) into job_times.  Returns the job count.
size_t avtpu_xstats(void* handle, int64_t* out, size_t n, int64_t* job_times,
                    size_t max_jobs) {
  const avtpu::XStats& st = ((avtpu::XtractResult*)handle)->stats;
  const int64_t all[avtpu::kXStats] = {
      st.t_start, st.t_walked, st.t_joined, st.t_end,
      st.threads, st.jobs, st.slices, st.failed,
      st.parse_ns, st.model_ns, st.job_ns, st.cpu_ns, st.field_bins};
  std::copy(all, all + std::min(n, avtpu::kXStats), out);
  size_t k = std::min(max_jobs, st.job_times.size());
  for (size_t j = 0; j < k; j++) {
    job_times[3 * j] = st.job_times[j].tid;
    job_times[3 * j + 1] = st.job_times[j].t0;
    job_times[3 * j + 2] = st.job_times[j].t1;
  }
  return st.job_times.size();
}

// Cheap GOP index (NAL + slice-header scan only, no CABAC parse): the
// multi-host work decomposition (parallel/multihost.py).
int avtpu_gop_count(const uint8_t* data, size_t size) {
  try {
    avtpu::Walker w(data, size);
    int n = 0;
    bool any = false;
    w.slices([&](const avtpu::SliceRec& rec) {
      if (!any || (rec.hdr.idr && rec.hdr.first_mb_in_slice == 0)) n++;
      any = true;
    });
    return n;
  } catch (...) {
    return -1;
  }
}

// Container fragment for GOPs [lo, hi) — see compress_gops_range.
// total_gops (optional) receives the file's GOP count.
size_t avtpu_compress_gops(const uint8_t* data, size_t size, int gop_lo,
                           int gop_hi, int threads, uint8_t** out,
                           int* total_gops) {
  try {
    int nt = threads > 0 ? threads
                         : std::min(16u, std::thread::hardware_concurrency());
    avtpu::Bytes v =
        avtpu::compress_gops_range(data, size, nt, gop_lo, gop_hi, total_gops);
    *out = (uint8_t*)malloc(v.size() ? v.size() : 1);
    memcpy(*out, v.data(), v.size());
    return v.size();
  } catch (...) {
    *out = nullptr;
    return 0;
  }
}

// Model-upgrade laboratory (mixlab.h); params[5], out[5].
int avtpu_mixlab(const uint8_t* data, size_t size, const double* params,
                 double* out) {
  try {
    return avtpu::mixlab_run(data, size, params, out);
  } catch (...) {
    return -1;
  }
}

// Reference-model replay scorer (refscore.h); out must hold 10 doubles.
// Returns 0 on success, -1 on internal error.
int avtpu_refscore(const uint8_t* data, size_t size, double* out) {
  try {
    return avtpu::refscore_run(data, size, out);
  } catch (...) {
    return -1;
  }
}

void avtpu_free(uint8_t* p) { free(p); }

}  // extern "C"
