// Native MIDI -> Octuple codec (a copy of pianobart_tpu/midi/native/).
//
// Host C++ fast path for the dataset tokenizer's hot loop: SMF parse +
// Octuple quantization in one pass, emitting (N, 9) int32 rows (8 token
// fields + task label, -1 when absent).  Semantics are bit-identical to the
// Python path in pianobart_tpu_torch/midi/parser.py and
// pianobart_tpu_torch/tokenizer/codec.py (which re-derive the math of the
// upstream reference convert.py:157-239); tests compare both paths, and the
// JAX package's, on random songs and corrupt bytes.
//
// Build:  g++ -O3 -std=c++17 -shared -fPIC -o libpbx_midi.so midi_codec.cpp
//         (pianobart_tpu_torch/midi/native.py does this at first use)
// ABI:    plain C (ctypes-friendly), see pbx_* exports at the bottom.

#include <algorithm>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

// ---- quantizer constants (vocab.py) ---------------------------------------
constexpr int kPosResolution = 16;
constexpr int kBeatNoteFactor = 4;
constexpr int kMaxNotesPerBar = 2;
constexpr int kMaxTsDenominator = 6;
constexpr int kDurationMax = 8;
constexpr int kVelocityQuant = 4;
constexpr int kTempoQuant = 12;
constexpr int kMinTempo = 16;
constexpr int kMaxTempo = 256;
constexpr int kMaxInst = 128;
constexpr int64_t kTruncPos = 1 << 16;

struct TS { int num, den; };

struct TsTable {
  std::map<std::pair<int, int>, int> to_bin;
  std::vector<TS> from_bin;
  TsTable() {
    for (int i = 0; i <= kMaxTsDenominator; ++i)
      for (int j = 1; j <= (1 << i) * kMaxNotesPerBar; ++j) {
        to_bin[{j, 1 << i}] = static_cast<int>(from_bin.size());
        from_bin.push_back({j, 1 << i});
      }
  }
};
const TsTable& ts_table() { static TsTable t; return t; }

struct DurTable {
  std::vector<int> enc;
  DurTable() {
    int dec_len = 0;
    for (int i = 0; i < kDurationMax; ++i)
      for (int j = 0; j < kPosResolution; ++j) {
        ++dec_len;
        for (int k = 0; k < (1 << i); ++k) enc.push_back(dec_len - 1);
      }
  }
};
const DurTable& dur_table() { static DurTable t; return t; }

int duration_to_bin(int64_t d) {
  const auto& e = dur_table().enc;
  if (d < 0) d = 0;
  return d < static_cast<int64_t>(e.size()) ? e[d] : e.back();
}

int tempo_to_bin(double bpm) {
  bpm = std::min(std::max(bpm, double(kMinTempo)), double(kMaxTempo));
  // match Python round(): half-to-even
  return static_cast<int>(std::nearbyint(std::log2(bpm / kMinTempo) * kTempoQuant));
}

TS reduce_ts(int num, int den) {
  while (den > (1 << kMaxTsDenominator) && den % 2 == 0 && num % 2 == 0) {
    den /= 2; num /= 2;
  }
  while (num > kMaxNotesPerBar * den) {
    for (int i = 2; i <= num; ++i)
      if (num % i == 0) { num /= i; break; }
  }
  return {num, den};
}

// ---- MIDI parse ------------------------------------------------------------
struct Note { int vel, pitch; int64_t start, end; };
struct Inst {
  int program; bool is_drum; std::string name;
  std::vector<Note> notes;
};
struct Meta { int64_t tick; double tempo; int num, den; bool is_tempo; };

struct Parsed {
  int ticks_per_beat = 480;
  std::vector<Inst> instruments;
  std::vector<Meta> tempos;     // is_tempo = true
  std::vector<Meta> timesigs;
  bool ok = false;
};

uint32_t read_varint(const uint8_t* p, size_t n, size_t& pos) {
  uint32_t v = 0;
  while (pos < n) {
    uint8_t b = p[pos++];
    v = (v << 7) | (b & 0x7F);
    if (!(b & 0x80)) break;
  }
  return v;
}

Parsed parse_midi(const uint8_t* data, size_t len) {
  Parsed out;
  size_t base = 0;
  if (len < 14) return out;
  if (std::memcmp(data, "MThd", 4) != 0) {
    static const uint8_t kHdr[4] = {'M', 'T', 'h', 'd'};
    const uint8_t* f = std::search(data, data + len, kHdr, kHdr + 4);
    if (f == data + len) return out;
    base = f - data;
    // re-check: an embedded MThd near the end left <14 bytes, and the
    // header reads below would run past the buffer (out of bounds)
    if (len - base < 14) return out;
  }
  const uint8_t* p = data + base;
  size_t n = len - base;
  auto rd32 = [&](size_t off) {
    return (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
           (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
  };
  auto rd16 = [&](size_t off) {
    return (uint32_t(p[off]) << 8) | uint32_t(p[off + 1]);
  };
  uint32_t hlen = rd32(4);
  uint32_t ntracks = rd16(10);
  uint32_t division = rd16(12);
  if (division & 0x8000) return out;  // SMPTE unsupported
  out.ticks_per_beat = static_cast<int>(division);

  // (track, channel, program) -> instrument index, insertion ordered
  std::map<std::tuple<int, int, int>, size_t> inst_idx;
  std::vector<std::tuple<int, int, int>> inst_order;

  size_t pos = 8 + hlen;
  for (uint32_t t = 0; t < ntracks && pos + 8 <= n; ++t) {
    bool is_track = std::memcmp(p + pos, "MTrk", 4) == 0;
    uint32_t clen = rd32(pos + 4);
    size_t body = pos + 8;
    size_t body_end = std::min(body + static_cast<size_t>(clen), n);
    pos = body + clen;
    if (!is_track) continue;

    int64_t tick = 0;
    uint8_t running = 0;
    std::string track_name;
    int chan_prog[16] = {0};
    // (channel, pitch) -> FIFO of (start, vel, inst_key)
    std::map<std::pair<int, int>, std::vector<std::tuple<int64_t, int, size_t>>> open;
    std::vector<size_t> local_insts;
    size_t q = body;

    auto get_inst = [&](int channel) -> size_t {
      auto key = std::make_tuple(static_cast<int>(t), channel,
                                 chan_prog[channel]);
      auto it = inst_idx.find(key);
      if (it != inst_idx.end()) return it->second;
      size_t idx = out.instruments.size();
      out.instruments.push_back({chan_prog[channel], channel == 9,
                                 track_name, {}});
      inst_idx[key] = idx;
      local_insts.push_back(idx);
      return idx;
    };
    auto close_note = [&](int channel, int pitch, int64_t end) {
      auto it = open.find({channel, pitch});
      if (it == open.end() || it->second.empty()) return;
      auto [start, vel, idx] = it->second.front();
      it->second.erase(it->second.begin());
      if (end > start)
        out.instruments[idx].notes.push_back({vel, pitch, start, end});
    };

    while (q < body_end) {
      tick += read_varint(p, body_end, q);
      if (q >= body_end) break;
      uint8_t status = p[q];
      if (status & 0x80) {
        ++q;
        if (status < 0xF0) running = status;
      } else {
        status = running;
        if (!status) break;
      }
      uint8_t kind = status & 0xF0;
      int channel = status & 0x0F;
      if (q + 1 > body_end) break;
      if (kind == 0x90) {
        if (q + 2 > body_end) break;
        int pitch = p[q], vel = p[q + 1]; q += 2;
        if (vel == 0) close_note(channel, pitch, tick);
        else open[{channel, pitch}].push_back({tick, vel, get_inst(channel)});
      } else if (kind == 0x80) {
        if (q + 2 > body_end) break;
        int pitch = p[q]; q += 2;
        close_note(channel, pitch, tick);
      } else if (kind == 0xA0 || kind == 0xB0 || kind == 0xE0) {
        q += 2;
      } else if (kind == 0xC0) {
        chan_prog[channel] = p[q]; q += 1;
      } else if (kind == 0xD0) {
        q += 1;
      } else if (status == 0xF0 || status == 0xF7) {
        uint32_t l = read_varint(p, body_end, q); q += l;
      } else if (status == 0xFF) {
        uint8_t mt = p[q]; ++q;
        uint32_t l = read_varint(p, body_end, q);
        if (q + l > body_end) break;
        if (mt == 0x51 && l >= 3) {
          uint32_t usq = (uint32_t(p[q]) << 16) | (uint32_t(p[q + 1]) << 8)
                         | p[q + 2];
          if (usq) out.tempos.push_back({tick, 60000000.0 / usq, 0, 0, true});
        } else if (mt == 0x58 && l >= 2) {
          // exponent >= 31 would be signed-shift UB (and wrap to a bogus
          // valid denominator); use -1 so ts validation rejects it with
          // the same "unsupported time signature" the Python path raises
          int e = p[q + 1];
          out.timesigs.push_back(
              {tick, 0.0, p[q], (e < 31) ? (1 << e) : -1, false});
        } else if (mt == 0x03) {
          track_name.assign(reinterpret_cast<const char*>(p + q), l);
          while (!track_name.empty() && track_name.back() == '\0')
            track_name.pop_back();
          // strip LEADING NULs too, matching the Python parser's
          // .strip('\0') — melody labels key off the exact name
          while (!track_name.empty() && track_name.front() == '\0')
            track_name.erase(track_name.begin());
          for (size_t idx : local_insts)
            if (out.instruments[idx].name.empty())
              out.instruments[idx].name = track_name;
        } else if (mt == 0x2F) {
          q += l;
          break;
        }
        q += l;
      } else {
        break;  // unknown status: stop this track, keep what we have
      }
    }
    // close dangling notes at final tick
    for (auto& [key, stack] : open)
      for (auto& [start, vel, idx] : stack)
        if (tick > start)
          out.instruments[idx].notes.push_back({vel, key.second, start, tick});
  }
  std::stable_sort(out.tempos.begin(), out.tempos.end(),
                   [](const Meta& a, const Meta& b) { return a.tick < b.tick; });
  std::stable_sort(out.timesigs.begin(), out.timesigs.end(),
                   [](const Meta& a, const Meta& b) { return a.tick < b.tick; });
  out.ok = true;
  return out;
}

// ---- quantization (codec.py midi_to_octuple) -------------------------------
int64_t time_to_pos(int64_t t, int tpb) {
  // Python round(): half-to-even on the rational t*16/tpb
  double x = double(t) * kPosResolution / tpb;
  return static_cast<int64_t>(std::nearbyint(x));
}

int melody_label(const std::string& name) {
  if (name == "MELODY") return 0;
  if (name == "BRIDGE") return 1;
  if (name == "PIANO") return 2;
  return 3;
}

int velocity_label(int v) {
  if (v >= 0 && v <= 15) return 0;
  if (v >= 112 && v <= 127) return 5;
  int label = (v - 32) / 16 + 1;
  if (v - 32 < 0 && (v - 32) % 16 != 0) label -= 1;  // floor division
  return label;
}

// task: 0 pretrain/other, 1 melody, 2 velocity
int encode(const Parsed& midi, int task, std::vector<int32_t>& rows) {
  std::fesetround(FE_TONEAREST);
  int64_t max_start = -1;
  for (const auto& inst : midi.instruments)
    for (const auto& nt : inst.notes)
      max_start = std::max(max_start, time_to_pos(nt.start, midi.ticks_per_beat));
  if (max_start < 0) return 0;
  int64_t max_pos = std::min(max_start + 1, kTruncPos);

  const auto& tst = ts_table();
  TS def_ts_r = reduce_ts(4, 4);
  int def_ts = tst.to_bin.at({def_ts_r.num, def_ts_r.den});
  int def_tempo = tempo_to_bin(120.0);

  std::vector<int32_t> ts_bin(max_pos, def_ts), tempo_bin(max_pos, def_tempo);
  for (size_t i = 0; i < midi.timesigs.size(); ++i) {
    int64_t lo = time_to_pos(midi.timesigs[i].tick, midi.ticks_per_beat);
    int64_t hi = (i + 1 < midi.timesigs.size())
        ? time_to_pos(midi.timesigs[i + 1].tick, midi.ticks_per_beat) : max_pos;
    if (midi.timesigs[i].den <= 0 || midi.timesigs[i].num <= 0)
      return -2;  // out-of-range exponent sentinel; reduce_ts would spin
    TS r = reduce_ts(midi.timesigs[i].num, midi.timesigs[i].den);
    auto it = tst.to_bin.find({r.num, r.den});
    if (it == tst.to_bin.end()) return -2;  // unsupported time signature
    for (int64_t j = std::max<int64_t>(lo, 0); j < std::min(hi, max_pos); ++j)
      ts_bin[j] = it->second;
  }
  for (size_t i = 0; i < midi.tempos.size(); ++i) {
    int64_t lo = time_to_pos(midi.tempos[i].tick, midi.ticks_per_beat);
    int64_t hi = (i + 1 < midi.tempos.size())
        ? time_to_pos(midi.tempos[i + 1].tick, midi.ticks_per_beat) : max_pos;
    int b = tempo_to_bin(midi.tempos[i].tempo);
    for (int64_t j = std::max<int64_t>(lo, 0); j < std::min(hi, max_pos); ++j)
      tempo_bin[j] = b;
  }

  std::vector<int32_t> bar_of(max_pos), pos_of(max_pos);
  {
    int64_t cnt = 0, bar = 0, measure = 0;
    for (int64_t j = 0; j < max_pos; ++j) {
      TS ts = tst.from_bin[ts_bin[j]];
      if (cnt == 0)
        measure = int64_t(ts.num) * kBeatNoteFactor * kPosResolution / ts.den;
      bar_of[j] = static_cast<int32_t>(bar);
      pos_of[j] = static_cast<int32_t>(cnt);
      if (++cnt >= measure) {
        if (cnt != measure) return -3;  // invalid ts change mid-measure
        cnt = 0;
        ++bar;
      }
    }
  }

  struct Row { int32_t f[9]; };
  std::vector<Row> enc;
  for (const auto& inst : midi.instruments) {
    int program = inst.is_drum ? kMaxInst : inst.program;
    int pitch_shift = inst.is_drum ? 128 : 0;
    int mlabel = melody_label(inst.name);
    for (const auto& nt : inst.notes) {
      int64_t sp = time_to_pos(nt.start, midi.ticks_per_beat);
      if (sp >= kTruncPos) continue;
      int64_t ep = time_to_pos(nt.end, midi.ticks_per_beat);
      Row r;
      r.f[0] = bar_of[sp];
      r.f[1] = pos_of[sp];
      r.f[2] = program;
      r.f[3] = nt.pitch + pitch_shift;
      r.f[4] = duration_to_bin(ep - sp);
      r.f[5] = nt.vel / kVelocityQuant;
      r.f[6] = ts_bin[sp];
      r.f[7] = tempo_bin[sp];
      r.f[8] = task == 1 ? mlabel : (task == 2 ? velocity_label(nt.vel) : -1);
      enc.push_back(r);
    }
  }
  std::sort(enc.begin(), enc.end(), [](const Row& a, const Row& b) {
    return std::lexicographical_compare(a.f, a.f + 9, b.f, b.f + 9);
  });
  rows.resize(enc.size() * 9);
  for (size_t i = 0; i < enc.size(); ++i)
    std::memcpy(&rows[i * 9], enc[i].f, 9 * sizeof(int32_t));
  return static_cast<int>(enc.size());
}

}  // namespace

extern "C" {

// Parses MIDI bytes and emits n*9 int32 Octuple rows (col 8 = label or -1).
// Returns n >= 0 on success; negative on error (-1 parse, -2 bad ts, -3
// invalid ts change).  Caller frees *out_rows with pbx_free.
int pbx_midi_to_octuple(const uint8_t* data, size_t len, int task,
                        int32_t** out_rows) {
  *out_rows = nullptr;
  Parsed midi = parse_midi(data, len);
  if (!midi.ok) return -1;
  std::vector<int32_t> rows;
  int n = encode(midi, task, rows);
  if (n <= 0) return n;
  *out_rows = static_cast<int32_t*>(std::malloc(rows.size() * sizeof(int32_t)));
  std::memcpy(*out_rows, rows.data(), rows.size() * sizeof(int32_t));
  return n;
}

void pbx_free(void* p) { std::free(p); }

int pbx_abi_version() { return 1; }

}  // extern "C"
